"""DeepFM and DCNv2 in the PyTorch port (``fuxictr_tpu_torch``) against the
JAX package: the columnar loader and the in-memory loader, the synthetic
Criteo schema and batches, numeric and dim-1 embeddings, the LR / FM
blocks, the cross networks, the initialisers, the models' forward and train
steps on ``configs/tiny`` (``DeepFM_test``, ``DCNv2_test``,
``DCNv2_mix_test``) over ``data/tiny_parquet`` and on a small synthetic
DCNv2 with numeric fields, ``multi_step``, and ``run_expid`` end to end.
Inputs come from numpy seeds and go to both sides, JAX weights are carried
over with ``params_from_jax``, and each comparison states its tolerance.
Every file a test writes is under ``tmp_path``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fuxictr_tpu.models.zoo  # noqa: F401  (registers the JAX zoo)
from fuxictr_tpu import config as jax_config
from fuxictr_tpu import experiment as jax_experiment
from fuxictr_tpu.data import array_dataset as jax_array_dataset
from fuxictr_tpu.data import loader as jax_loader
from fuxictr_tpu.features import FeatureMap as JaxFeatureMap
from fuxictr_tpu.models.base import RankModel as JaxRankModel
from fuxictr_tpu.models.registry import MODEL_REGISTRY
from fuxictr_tpu.ops import blocks as jax_blocks
from fuxictr_tpu.ops import embedding as jax_embedding
from fuxictr_tpu.ops import interactions as jax_interactions
from fuxictr_tpu.utils import synthetic as jax_synthetic
from fuxictr_tpu_torch import experiment
from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.data import array_dataset
from fuxictr_tpu_torch.data.loader import InMemoryDataLoader
from fuxictr_tpu_torch.features import FeatureMap
from fuxictr_tpu_torch.models import get_model
from fuxictr_tpu_torch.models.base import RankModel
from fuxictr_tpu_torch.ops import blocks, interactions
from fuxictr_tpu_torch.ops.common import xavier_normal_
from fuxictr_tpu_torch.ops.embedding import (INVERSE_KEY, EmbeddingLayout,
                                             FeatureEmbedding)
from fuxictr_tpu_torch.utils import synthetic
from fuxictr_tpu_torch.utils.convert import params_from_jax
from test_torch_sim import _bf16_tree, _random_like

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs", "tiny")
DATA_ROOT = os.path.join(ROOT, "data")
EXPIDS = ["DeepFM_test", "DCNv2_test", "DCNv2_mix_test"]
TOL = 1e-5        # f32: sums and products in another order


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _expid_params(expid, **overrides):
    """The expid's config with the data paths of ``data/`` (the dataset
    config points at an absent reference tree)."""
    params = jax_config.load_config(CONFIG_DIR, expid)
    ds = params["dataset_id"]
    params.update(data_root=DATA_ROOT + os.sep, **{
        f"{s}_data": os.path.join(DATA_ROOT, ds, f"{s}.parquet")
        for s in ("train", "valid", "test")})
    if ds == "tiny_longctr":
        params.update({f"{t}_info": os.path.join(DATA_ROOT, ds,
                                                 f"{t}_info.parquet")
                       for t in ("user", "item")})
    params.update(overrides)
    return params


def _feature_maps(params):
    fms = []
    for cls in (JaxFeatureMap, FeatureMap):
        fm = cls(params["dataset_id"],
                 os.path.join(DATA_ROOT, params["dataset_id"]))
        fm.load(os.path.join(DATA_ROOT, params["dataset_id"],
                             "feature_map.json"), params)
        fms.append(fm)
    return fms


def _synthetic_maps(**kw):
    return (jax_synthetic.make_synthetic_feature_map(**kw),
            synthetic.make_synthetic_feature_map(**kw))


# ------------------------------------------------------------- loading

@pytest.mark.parametrize("path", ["tiny_parquet/train.parquet",
                                  "tiny_parquet/valid",
                                  "tiny_npz/train.npz"])
def test_load_columns_matches_jax(path):
    """Parquet (with or without the extension) and npz: the same columns,
    types and values."""
    ds = path.split("/")[0]
    jfm, tfm = _feature_maps({"dataset_id": ds})
    full = os.path.join(DATA_ROOT, path)
    ref = jax_array_dataset.load_columns(jfm, full)
    out = array_dataset.load_columns(tfm, full)
    assert list(out) == list(ref)
    for key, val in ref.items():
        assert out[key].dtype == val.dtype, key
        np.testing.assert_array_equal(out[key], val, err_msg=key)
    assert array_dataset.expand_path(full) \
        == jax_array_dataset.expand_path(full)


def test_load_columns_refuses_tfrecord():
    _, tfm = _feature_maps({"dataset_id": "tiny_parquet"})
    with pytest.raises(NotImplementedError, match="tfrecord"):
        array_dataset.load_columns(tfm, "x.tfrecord")


@pytest.mark.parametrize("shuffle,batch_size", [(True, 32), (False, 32),
                                                (True, 128)])
def test_in_memory_loader_matches_jax(shuffle, batch_size):
    """Two passes over ``tiny_parquet``'s 100 train rows: the same rows in
    every batch (``default_rng(seed + epoch)``), the last batch padded
    with zero rows and mask 0."""
    jfm, tfm = _feature_maps({"dataset_id": "tiny_parquet"})
    path = os.path.join(DATA_ROOT, "tiny_parquet", "train.parquet")
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=2019)
    ref_loader = jax_loader.InMemoryDataLoader(jfm, path, **kw)
    port = InMemoryDataLoader(tfm, path, **kw)
    assert len(port) == len(ref_loader) == -(-100 // batch_size)
    epochs = []
    for _ in range(2):
        ref, out = list(ref_loader), list(port)
        assert len(out) == len(ref)
        for j, t in zip(ref, out):
            assert set(t) == set(j)
            for key in j:
                assert t[key].dtype == j[key].dtype
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        mask = out[-1][SAMPLE_MASK_KEY]
        n_last = 100 - batch_size * (len(out) - 1)
        assert mask.sum() == n_last and not mask[n_last:].any()
        assert not out[-1]["userid"][n_last:].any()
        epochs.append(np.concatenate([b["clk"] for b in out]))
    assert shuffle != np.array_equal(epochs[0], epochs[1]) or not shuffle


def test_in_memory_loader_is_one_host():
    _, tfm = _feature_maps({"dataset_id": "tiny_parquet"})
    with pytest.raises(NotImplementedError, match="multi-host"):
        InMemoryDataLoader(tfm, os.path.join(DATA_ROOT, "tiny_parquet",
                                             "train.parquet"), num_hosts=2)


@pytest.mark.parametrize("kw", [
    dict(), dict(num_categorical=4, num_numeric=3, vocab_size=50),
    dict(num_categorical=3, num_numeric=0, vocab_size=[7, 9],
         num_sequence=1, seq_len=5, embedding_dim=8)])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_schema_and_batch_match_jax(kw, seed):
    """The same schema, and byte-equal batches from the same seed."""
    jfm, tfm = _synthetic_maps(**kw)
    assert tfm.features == jfm.features and tfm.labels == jfm.labels
    assert tfm.column_index == jfm.column_index
    assert (tfm.num_fields, tfm.total_features, tfm.input_length) \
        == (jfm.num_fields, jfm.total_features, jfm.input_length)
    ref = jax_synthetic.make_synthetic_batch(jfm, batch_size=64, seed=seed)
    out = synthetic.make_synthetic_batch(tfm, batch_size=64, seed=seed)
    assert list(out) == list(ref)
    for key, val in ref.items():
        assert out[key].dtype == val.dtype and out[key].tobytes() \
            == val.tobytes(), key


# ---------------------------------------------------------- embeddings

def _embedding_batch(fm, n, seed, dedup=False):
    batch = synthetic.make_synthetic_batch(fm, batch_size=n, seed=seed)
    if dedup:
        inv = np.random.default_rng(seed).integers(0, n, 3 * n)
        batch[INVERSE_KEY] = inv.astype(np.int32)
    return {k: v for k, v in batch.items() if k in fm.features
            or k == INVERSE_KEY}


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("size_buckets", [None, (30,)])
def test_numeric_and_categorical_embedding_matches_jax(dedup, size_buckets):
    """4 categorical (vocab 20 and 50: one table, or two with buckets
    (30,)) and 3 numeric fields: the flat embedding and the gradients of
    every table and of ``numeric_d8``, f32, within 1e-5. A deduped batch
    (``__item_inverse__``) expands the numeric fields through it too."""
    jfm, tfm = _synthetic_maps(num_categorical=4, num_numeric=3,
                               vocab_size=[20, 50], embedding_dim=8)
    batch = _embedding_batch(tfm, 10, seed=1, dedup=dedup)
    layer = jax_embedding.FeatureEmbedding(jfm, 8, size_buckets=size_buckets)
    params = jax.device_get(layer.init(jax.random.PRNGKey(0), batch)
                            ["params"])
    params = _random_like(params, np.random.default_rng(0))
    assert set(params) >= {"numeric_d8"}
    port = FeatureEmbedding(tfm, 8, size_buckets=size_buckets)
    port.load_state_dict(params_from_jax(params))
    ct = np.random.default_rng(2).normal(
        size=(30 if dedup else 10, 7 * 8)).astype(np.float32)

    def loss(p):
        return jnp.sum(layer.apply({"params": p}, batch, flatten_emb=True)
                       * ct)

    ref_out = layer.apply({"params": params}, batch, flatten_emb=True)
    ref_grads = params_from_jax(jax.device_get(jax.grad(loss)(params)))
    out = port({k: torch.from_numpy(v) for k, v in batch.items()},
               flatten_emb=True)
    np.testing.assert_allclose(out.detach().numpy(), _np(ref_out),
                               rtol=TOL, atol=TOL)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(ct)),
                                list(port.parameters()))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("force_dim,use_sharing,use_pretrain", [
    (None, True, True), (1, False, False), (1, True, True), (3, False, True)])
def test_layout_options_match_jax(force_dim, use_sharing, use_pretrain):
    """``force_dim``, ``use_sharing`` and ``use_pretrain`` give the JAX
    layout: C2 shares C1's rows unless sharing is off; C3's pretrained
    vectors are ignored without ``use_pretrain``."""
    jfm, tfm = _synthetic_maps(num_categorical=3, num_numeric=2,
                               vocab_size=20, embedding_dim=4)
    for fm in (jfm, tfm):
        fm.features["C2"]["share_embedding"] = "C1"
        fm.features["C3"]["pretrained_emb"] = "unused.h5"
    kw = dict(force_dim=force_dim, use_sharing=use_sharing,
              use_pretrain=use_pretrain)
    ref = jax_embedding.EmbeddingLayout(jfm, 4, **kw)
    out = EmbeddingLayout(tfm, 4, **kw)
    assert out.tables == ref.tables and out.numeric == ref.numeric
    assert list(out.fields) == list(ref.fields)
    for name, plan in ref.fields.items():
        assert {k: v for k, v in out.fields[name].items() if k != "spec"} \
            == {k: v for k, v in plan.items() if k != "spec"}, name


def test_pretrained_field_still_raises():
    _, tfm = _synthetic_maps(num_categorical=2, num_numeric=0, vocab_size=9)
    tfm.features["C2"]["pretrained_emb"] = "unused.h5"
    with pytest.raises(NotImplementedError, match="C2"):
        FeatureEmbedding(tfm, 4)
    lr = blocks.LogisticRegression(tfm)     # use_pretrain=False: fused rows
    assert {n for n, _ in lr.named_parameters()} \
        == {"embedding.table_d1", "bias"}


# -------------------------------------------------------------- blocks

def _grads_match(port_mod, port_inputs, ref_fn, ref_params, ref_inputs,
                 ct, tol):
    """Forward and gradients (parameters and inputs) of a port module
    against ``jax.vjp`` of ``ref_fn(params, *inputs)``."""
    ref_out, vjp = jax.vjp(ref_fn, ref_params, *ref_inputs)
    ref_grads = vjp(jnp.asarray(ct, ref_out.dtype))
    out = port_mod(*port_inputs)
    assert out.dtype == getattr(torch, str(ref_out.dtype))
    np.testing.assert_allclose(out.float().detach().numpy(), _np(ref_out),
                               rtol=tol, atol=tol)
    params = dict(port_mod.named_parameters())
    leaves = list(params.values()) + [t for t in port_inputs
                                      if torch.is_tensor(t)
                                      and t.requires_grad]
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(ct).to(out.dtype))
    ref_param_grads = params_from_jax(
        jax.tree_util.tree_map(_np, ref_grads[0]))
    for (name, _), g in zip(params.items(), grads):
        ref = ref_param_grads[name].numpy()
        np.testing.assert_allclose(g.float().numpy(), ref, rtol=tol,
                                   atol=tol * max(1.0, np.abs(ref).max()),
                                   err_msg=name)
    for g, r in zip(grads[len(params):], ref_grads[1:]):
        np.testing.assert_allclose(g.float().numpy(), _np(r), rtol=tol,
                                   atol=tol * max(1.0, np.abs(_np(r)).max()))


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


# bf16 layers: the same ops in the same types on both sides; a sum taken
# in another order (torch sums bf16 in f32 and rounds once, XLA's CPU
# reduce rounds each partial sum) moves a result by a few bf16 steps
# (2**-8 relative each) of the largest entry: measured at most 5.4 steps
# (CrossNetMix's gradients), limit 8
BLOCK_TOL = {"float32": TOL, "bfloat16": 2 ** -5}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fm_pairwise_sum_matches_jax(dtype):
    """[6, 14, 4] (tiny_parquet's 14 fields at dim 4): forward and the
    input's gradient; bf16 run op by op on the JAX side."""
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(6, 14, 4)).astype(np.float32)
    ct = rng.normal(size=(6, 1)).astype(np.float32)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(emb).to(tdt).requires_grad_()
    with jax.disable_jit():
        _grads_match(_Fn(blocks.fm_pairwise_sum), [x],
                     lambda p, e: jax_blocks.fm_pairwise_sum(e), {},
                     [jnp.asarray(emb, dtype)], ct, BLOCK_TOL[dtype])


def test_factorization_machine_matches_jax():
    """LR (``fm.lr.embedding.table_d1`` + ``numeric_d1`` + bias) plus the
    pairwise term, on a synthetic map with numeric fields: forward and
    every gradient, f32."""
    jfm, tfm = _synthetic_maps(num_categorical=4, num_numeric=3,
                               vocab_size=30, embedding_dim=4)
    batch = _embedding_batch(tfm, 8, seed=5)
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(8, 7, 4)).astype(np.float32)
    ct = rng.normal(size=(8, 1)).astype(np.float32)
    fm_block = jax_blocks.FactorizationMachine(jfm)
    params = _random_like(jax.device_get(fm_block.init(
        jax.random.PRNGKey(0), batch, emb)["params"]), rng)
    assert set(params["lr"]["embedding"]) == {"table_d1", "numeric_d1"}
    port = blocks.FactorizationMachine(tfm)
    port.load_state_dict(params_from_jax(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    x = torch.from_numpy(emb).requires_grad_()
    _grads_match(port, [tb, x],
                 lambda p, e: fm_block.apply({"params": p}, batch, e),
                 params, [jnp.asarray(emb)], ct, TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", [False, True], ids=["v2", "mix"])
def test_cross_network_matches_jax(mix, dtype):
    """CrossNetV2 (3 layers) and CrossNetMix (2 layers, 3 experts, rank 4)
    on [5, 12]: forward, every parameter's gradient and the input's. In
    bf16 the JAX side runs op by op on cast parameters, as the train step
    casts them."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    ct = rng.normal(size=(5, 12)).astype(np.float32)
    if mix:
        ref_mod = jax_interactions.CrossNetMix(12, 2, low_rank=4,
                                               num_experts=3)
        port = interactions.CrossNetMix(12, 2, low_rank=4, num_experts=3)
    else:
        ref_mod = jax_interactions.CrossNetV2(12, 3)
        port = interactions.CrossNetV2(12, 3)
    params = jax.device_get(ref_mod.init(jax.random.PRNGKey(0), x)
                            ["params"])
    params = _random_like(params, rng)
    port.load_state_dict(params_from_jax(params))
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        params = _bf16_tree(params)
        port = port.to(tdt)
    with jax.disable_jit():
        _grads_match(port, [torch.from_numpy(x).to(tdt).requires_grad_()],
                     lambda p, a: ref_mod.apply({"params": p}, a), params,
                     [jnp.asarray(x, dtype)], ct, BLOCK_TOL[dtype])


@pytest.mark.parametrize("shape", [(4, 256, 64), (8, 32, 32), (512, 384)],
                         ids=["UV", "C", "dense"])
def test_xavier_normal_moments_match_jax(shape):
    """``glorot_normal`` at a large shape: the port's draws (flax layout
    for 3-D, ``[out, in]`` for 2-D) have the JAX draws' standard deviation
    within 2% and zero mean within 3 standard errors, and both are cut at
    two untruncated standard deviations."""
    ref = np.asarray(jax.nn.initializers.glorot_normal()(
        jax.random.PRNGKey(0), shape if len(shape) == 3 else shape[::-1]))
    out = torch.empty(shape)
    xavier_normal_(out, torch.Generator().manual_seed(0))
    out = out.numpy()
    if len(shape) == 3:
        fan_in, fan_out = shape[0] * shape[1], shape[0] * shape[2]
    else:
        fan_out, fan_in = shape
    std = np.sqrt(2.0 / (fan_in + fan_out))
    assert abs(out.std() / ref.std() - 1) < 0.02
    assert abs(out.std() / std - 1) < 0.02
    assert abs(out.mean()) < 3 * std / np.sqrt(out.size)
    limit = 2 * std / 0.87962566103423978
    assert np.abs(out).max() <= limit and np.abs(ref).max() <= limit * 1.0001


def test_numeric_init_moments_match_jax():
    """``numeric_d{dim}``: normal with std sqrt(2 / (1 + dim)), untruncated,
    as the JAX layer draws it (16 fields x 4096 dims here)."""
    jfm, tfm = _synthetic_maps(num_categorical=0, num_numeric=16,
                               embedding_dim=4096)
    batch = _embedding_batch(tfm, 2, seed=0)
    ref = np.asarray(jax_embedding.FeatureEmbedding(jfm, 4096).init(
        jax.random.PRNGKey(0), batch)["params"]["numeric_d4096"])
    out = FeatureEmbedding(tfm, 4096, generator=torch.Generator()
                           .manual_seed(0)).numeric_d4096.detach().numpy()
    std = np.sqrt(2.0 / 4097)
    assert out.shape == ref.shape == (16, 4096)
    for arr in (out, ref):
        assert abs(arr.std() / std - 1) < 0.02
        assert np.abs(arr).max() > 3.5 * std          # not truncated


# -------------------------------------------------------------- models

def _model_pair(name, jfm, tfm, params, compute_dtype=None, seed=2019):
    """A JAX model and a port model of ``name`` on the same seeded weights
    (``_random_like``: spread enough that predictions vary)."""
    params = dict(params, compute_dtype=compute_dtype)
    jax_model = MODEL_REGISTRY[name](jfm, **params)
    jax_model.init_params()
    weights = _random_like(jax.device_get(jax_model.state.params),
                           np.random.default_rng(seed))
    jax_model.state = jax_model.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, weights))
    port = get_model(name)(tfm, device="cpu", **params)
    port.load_state_dict(params_from_jax(weights))
    return jax_model, port, weights


def _tiny(expid, **overrides):
    params = _expid_params(expid, **overrides)
    jfm, tfm = _feature_maps(params)
    name = params.pop("model")
    return name, jfm, tfm, params


def _tiny_batches(jfm, tfm, split, batch_size):
    path = os.path.join(DATA_ROOT, "tiny_parquet", f"{split}.parquet")
    return (list(jax_loader.InMemoryDataLoader(jfm, path,
                                               batch_size=batch_size)),
            list(InMemoryDataLoader(tfm, path, batch_size=batch_size)))


@pytest.mark.parametrize("expid", EXPIDS)
def test_ranking_predict_matches_jax(expid):
    """``predict`` over ``tiny_parquet``'s validation split in batches of
    32 (the last padded), f32, within 1e-5; in bf16 (``compute_dtype``)
    the port sits closer to JAX bf16 (op by op) than JAX f32 does, by at
    least half, and within 1e-5 of it."""
    name, jfm, tfm, params = _tiny(expid)
    jax32, port32, weights = _model_pair(name, jfm, tfm, params)
    jax16, port16, _ = _model_pair(name, jfm, tfm, params, "bfloat16")
    jb, tb = _tiny_batches(jfm, tfm, "valid", 32)
    ref32 = jax32.predict(jb)
    with jax.disable_jit():
        ref16 = jax16.predict(jb)
    out32, out16 = port32.predict(tb), port16.predict(tb)
    assert out32.shape == ref32.shape == (100,) and ref32.std() > 0.02
    np.testing.assert_allclose(out32, ref32, rtol=0, atol=TOL)
    gap = np.abs(ref32 - ref16).max()
    err = np.abs(out16 - ref16).max()
    assert gap > 1e-4 and err <= gap / 2 and err <= TOL, (err, gap)


def _jax_steps(jax_model, batches, steps):
    """``steps`` JAX train steps; the losses and the params after each."""
    step = jax_model._train_step_body()
    if jax_model._compute_dtype is None:
        step = jax.jit(step)
    state, losses, params = jax_model.state, [], []
    for i in range(steps):
        state, loss = step(state, batches[i], jax.random.PRNGKey(i))
        losses.append(float(loss))
        params.append(params_from_jax(jax.device_get(state.params)))
    return np.array(losses), params


def _port_steps(port, batches, steps):
    losses, params = [], []
    for batch in batches[:steps]:
        losses.append(float(port.train_step(batch)))
        params.append({k: v.clone() for k, v in port.state_dict().items()})
    return np.array(losses), params


def _max_diff(a, b):
    return max(float((a[k] - v).abs().max()) for k, v in b.items())


def _mean_diff(a, b):
    return float(torch.cat([(a[k] - v).abs().reshape(-1)
                            for k, v in b.items()]).mean())


def _jax_grads(jax_model, batch):
    """The gradients of the JAX train step's loss at the model's params,
    written as its ``loss_fn`` computes it: float params cast to the
    compute type, the net in training mode, outputs back to f32, the
    mask-weighted loss plus the regularizers."""
    dtype = jax_model._compute_dtype
    state = jax_model.state

    def loss_fn(params):
        if dtype is not None:
            params_c = jax.tree_util.tree_map(lambda x: x.astype(dtype),
                                              params)
        else:
            params_c = params
        out, _ = jax_model.net.apply(
            {"params": params_c, **state.model_state}, batch, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        out = {k: v.astype(jnp.float32) for k, v in out.items()}
        loss = jax_model.add_loss(out, jnp.asarray(batch["clk" if "clk" in
                                                         batch else "label"])
                                  .reshape(-1, 1), batch[SAMPLE_MASK_KEY])
        return loss + jax_model.regularization_loss(params)
    return params_from_jax(jax.device_get(jax.grad(loss_fn)(state.params)))


def _check_steps(name, jfm, tfm, params, jb, tb, steps=5):
    """Train steps from the same weights against JAX.

    f32: five steps, losses within 1e-5 relative and every parameter
    within 1e-5.

    bf16 (``compute_dtype``; JAX op by op). The first batch's gradients:
    the same ops in the same types, but a bf16 sum over the batch (a bias
    gradient) rounds once here where XLA's CPU reduce rounds each partial
    sum, so each gradient is within four bf16 steps (4 * 2**-8) of its
    tensor's largest entry of JAX bf16's (measured at most 2.02 steps).
    That is as large as the f32-vs-bf16 gap of some small gradients, so
    the five steps are held to the gap between JAX's f32 and bf16 runs:
    Adam magnifies last-bit differences wherever a gradient element is
    near zero, since its step
    is about ``lr`` times the gradient's sign whatever its size (a sign
    flipped by one bf16 rounding moves the element by 2 ``lr``); so the
    worst loss and the worst element stay under the gap, and the mean
    element under a quarter of it (measured at most 0.73 of the gap for
    the worst element and 0.16 for the mean, on ``DCNv2_test`` and
    ``DCNv2_mix_test``, and under 0.01 elsewhere). A port that computed in
    f32 would sit a whole gap away. The table gradients of bf16 accumulate
    duplicate ids in bf16 on both sides: the parameters are cast before
    the gather."""
    jax32, port32, _ = _model_pair(name, jfm, tfm, params)
    ref_losses, ref_params = _jax_steps(jax32, jb, steps)
    losses, _ = _port_steps(port32, tb, steps)
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL)
    state = port32.state_dict()
    assert set(ref_params[-1]) == set(dict(port32.named_parameters()))
    for key, val in ref_params[-1].items():
        np.testing.assert_allclose(state[key].numpy(), val.numpy(), rtol=0,
                                   atol=TOL, err_msg=key)

    jax16, port16, _ = _model_pair(name, jfm, tfm, params, "bfloat16")
    with jax.disable_jit():
        ref_g16 = _jax_grads(jax16, jb[0])
    _, grads = port16.loss_and_grads(tb[0])
    for (key, _), g in zip(port16.named_parameters(), grads):
        ref = ref_g16[key]
        err = float((g - ref).abs().max())
        assert err <= 4 * 2 ** -8 * float(ref.abs().max()), (key, err)
    with jax.disable_jit():
        ref16_losses, ref16_params = _jax_steps(jax16, jb, steps)
    losses16, params16 = _port_steps(port16, tb, steps)
    loss_gap = np.abs(ref_losses - ref16_losses).max()
    assert loss_gap > 1e-5
    assert np.abs(losses16 - ref16_losses).max() < loss_gap
    last, ref_last = params16[-1], ref16_params[-1]
    assert _max_diff(last, ref_last) < _max_diff(ref_params[-1], ref_last)
    assert _mean_diff(last, ref_last) \
        <= _mean_diff(ref_params[-1], ref_last) / 4
    assert all(p.dtype == torch.float32 for p in port16.parameters())


@pytest.mark.parametrize("expid", EXPIDS)
def test_ranking_train_steps_match_jax(expid):
    """``tiny_parquet`` in batches of 16 (``userid`` repeats within a
    batch, so the table gradients add duplicate ids); see
    :func:`_check_steps`."""
    name, jfm, tfm, params = _tiny(expid)
    jb, tb = _tiny_batches(jfm, tfm, "train", 16)
    _check_steps(name, jfm, tfm, params, jb, tb)


@pytest.mark.parametrize("structure", ["parallel", "stacked_parallel",
                                       "crossnet_only", "stacked"])
def test_synthetic_dcnv2_with_numeric_fields_matches_jax(structure):
    """A small DCNv2 of ``bench.py``'s form: 4 categorical fields (vocab
    50) and 3 numeric, dim 8, two cross layers and [32, 16] towers, in each
    structure (``stacked`` with the low-rank mixture), batches of 64 from
    ``make_synthetic_batch``; see :func:`_check_steps`. In bf16 the numeric
    fields' float32 values promote the embedding, and all that follows,
    to float32, as jnp promotes them."""
    jfm, tfm = _synthetic_maps(num_categorical=4, num_numeric=3,
                               vocab_size=50, embedding_dim=8)
    params = dict(model_id="DCNv2_small", embedding_dim=8,
                  model_structure=structure, num_cross_layers=2,
                  use_low_rank_mixture=structure == "stacked", low_rank=4,
                  num_experts=2, stacked_dnn_hidden_units=[32, 16],
                  parallel_dnn_hidden_units=[32, 16])
    batches = [synthetic.make_synthetic_batch(tfm, 64, seed=s)
               for s in range(5)]
    _check_steps("DCNv2", jfm, tfm, params, batches, batches)


def test_multi_step_matches_jax_scan():
    """``multi_step`` over a batch stacked K = 3, on the card's layout
    (tensors placed first): the mean loss and the parameters of JAX's
    ``_make_multi_step`` (one scan) within 1e-5, and bitwise the port's own
    three ``train_step`` calls."""
    jfm, tfm = _synthetic_maps(num_categorical=4, num_numeric=3,
                               vocab_size=50, embedding_dim=8)
    params = dict(embedding_dim=8, num_cross_layers=2,
                  parallel_dnn_hidden_units=[16], learning_rate=0.01)
    jax_model, port, weights = _model_pair("DCNv2", jfm, tfm, params)
    once = get_model("DCNv2")(tfm, device="cpu", **params)
    once.load_state_dict(params_from_jax(weights))
    batches = [synthetic.make_synthetic_batch(tfm, 32, seed=s)
               for s in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jax_model._ensure_optimizer()
    state, ref_loss = jax_model._make_multi_step()(
        jax_model.state, stacked, jax.random.PRNGKey(0))
    loss = port.multi_step(port._place_batch(stacked))
    assert loss.shape == () and abs(float(loss) - float(ref_loss)) \
        <= TOL * abs(float(ref_loss))
    for key, val in params_from_jax(jax.device_get(state.params)).items():
        np.testing.assert_allclose(port.state_dict()[key].numpy(),
                                   val.numpy(), rtol=0, atol=TOL,
                                   err_msg=key)
    losses = [once.train_step(b) for b in batches]
    assert torch.equal(torch.stack(losses).mean(), loss)
    for key, val in once.state_dict().items():
        assert torch.equal(port.state_dict()[key], val), key


# ---------------------------------------------------------- run_expid

def _run_both(expid, tmp_path, monkeypatch, **overrides):
    """``run_expid`` of the JAX package and of the port (on the CPU) for
    ``expid``, from the same seeded weights: the JAX model's init is
    replaced by ``_random_like`` of it, and the port's ``fit`` starts by
    loading those weights. Returns both results and, per evaluation, the
    logs, learning rate, epoch and stop flag of each side."""
    records, weights = {"jax": [], "port": []}, {}

    def record(cls, key, lr_of):
        inner = cls.checkpoint_and_earlystop

        def wrapped(self, logs, *args, **kw):
            out = inner(self, logs, *args, **kw)
            records[key].append((dict(logs), lr_of(self), self._epoch_index,
                                 self._stop_training))
            return out
        monkeypatch.setattr(cls, "checkpoint_and_earlystop", wrapped)

    record(JaxRankModel, "jax", lambda m: float(
        JaxRankModel._find_hyperparam_nodes(m.state.opt_state)[0]
        .hyperparams["learning_rate"]))
    record(RankModel, "port", lambda m: float(m.learning_rate))
    init_params, fit = JaxRankModel.init_params, RankModel.fit

    def seeded_init(self):
        init_params(self)
        weights.update(_random_like(jax.device_get(self.state.params),
                                    np.random.default_rng(2019)))
        self.state = self.state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, weights))

    def seeded_fit(self, *args, **kw):
        self.load_state_dict(params_from_jax(weights))
        return fit(self, *args, **kw)

    monkeypatch.setattr(JaxRankModel, "init_params", seeded_init)
    monkeypatch.setattr(RankModel, "fit", seeded_fit)
    params = _expid_params(expid, **overrides)
    ref = jax_experiment.run_expid(
        None, expid, params=dict(params, model_root=str(tmp_path / "jax")))
    out = experiment.run_expid(
        None, expid, params=dict(params, model_root=str(tmp_path / "port")),
        device="cpu")
    return ref, out, records


@pytest.mark.parametrize("expid", EXPIDS + ["SIM_test"])
def test_run_expid_matches_jax(expid, tmp_path, monkeypatch):
    """Up to six epochs of ``run_expid`` on ``tiny_parquet`` (SIM on
    ``tiny_longctr``) at learning rate 0.1, a shuffled train loader whose
    last batch is padded: at every evaluation the same monitored
    validation AUC (within 1e-5), learning rate and epoch; the rate decays
    on the plateau and both stop early at the same epoch; then the same
    final validation and test metrics (within 1e-5). The port writes its
    log, weights and the result line under ``tmp_path``."""
    result_file = tmp_path / "results.csv"
    ref, out, records = _run_both(expid, tmp_path, monkeypatch, epochs=6,
                                  learning_rate=0.1)
    assert len(records["port"]) == len(records["jax"]) >= 3
    assert records["jax"][-1][3] and records["jax"][-1][1] < 0.1 / 50
    for (rlogs, rlr, repoch, rstop), (logs, lr, epoch, stop) in zip(
            records["jax"], records["port"]):
        assert set(logs) == set(rlogs)
        for key in rlogs:
            assert abs(logs[key] - rlogs[key]) <= TOL, (key, logs, rlogs)
        assert (lr, epoch, stop) == (rlr, repoch, rstop)
    for split in ("valid", "test"):
        for key in ("AUC", "logloss"):
            assert abs(out[split][key] - ref[split][key]) <= TOL, split
    ds = _expid_params(expid)["dataset_id"]
    assert sorted(os.listdir(tmp_path / "port" / ds)) \
        == [f"{expid}.log", f"{expid}.pt"]
    experiment.run_expid(None, expid, result_file=str(result_file),
                         params=_expid_params(
                             expid, model_root=str(tmp_path / "again")),
                         device="cpu")
    line = result_file.read_text()
    assert f"[exp_id] {expid},[dataset_id] {ds},[train] N.A.,[val] " \
        "logloss: " in line and line.count("\n") == 1


def test_experiment_main_writes_the_result_line(tmp_path):
    """``python -m fuxictr_tpu_torch.experiment --config DIR --expid ID
    --device cpu`` on a config directory whose dataset section points at
    ``data/tiny_parquet``: the result line lands in ``DIR/<DIR's
    name>.csv``."""
    import yaml
    config = tmp_path / "cfg"
    config.mkdir()
    model_cfg = jax_config.load_model_config(CONFIG_DIR, "DCNv2_test")
    model_cfg.update(model_root=str(tmp_path / "ckpt"))
    (config / "model_config.yaml").write_text(
        yaml.safe_dump({"DCNv2_test": model_cfg}))
    data = _expid_params("DCNv2_test")
    (config / "dataset_config.yaml").write_text(yaml.safe_dump(
        {"tiny_parquet": {k: data[k] for k in (
            "data_root", "data_format", "train_data", "valid_data",
            "test_data")}}))
    experiment.main(["--config", str(config), "--expid", "DCNv2_test",
                     "--device", "cpu"])
    lines = (config / "cfg.csv").read_text().splitlines()
    assert len(lines) == 1 and "[exp_id] DCNv2_test" in lines[0]


@pytest.mark.parametrize("overrides,shared,match", [
    (dict(data_format="csv"), None, "csv"),
    (dict(use_mesh=True), None, "mesh"),
    (dict(coordinator_address="localhost:1234"), None, "multi-process"),
    (dict(), {}, "shared")])
def test_run_expid_refuses_what_is_not_ported(overrides, shared, match,
                                              tmp_path):
    params = _expid_params("DeepFM_test", model_root=str(tmp_path),
                           **overrides)
    with pytest.raises(NotImplementedError, match=match):
        experiment.run_expid(None, "DeepFM_test", params=params,
                             shared=shared, device="cpu")
    assert not os.listdir(tmp_path)
