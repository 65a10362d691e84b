"""SIM serving in the PyTorch port (``fuxictr_tpu_torch``) against the JAX
package on ``configs/tiny`` ``SIM_test`` over ``data/tiny_longctr``: the
config, the loader's batches, the layers, the whole forward on copied
weights, and the metrics. Weights and scores are drawn from numpy seeds and
handed to both sides; every comparison states its tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fuxictr_tpu.models.zoo  # noqa: F401  (registers SIM)
from fuxictr_tpu import config as jax_config
from fuxictr_tpu import metrics as jax_metrics
from fuxictr_tpu.data.longctr_loader import \
    LongCTRDataLoader as JaxLongCTRLoader
from fuxictr_tpu.features import FeatureMap as JaxFeatureMap
from fuxictr_tpu.models.registry import MODEL_REGISTRY
from fuxictr_tpu.ops import attention as jax_attention
from fuxictr_tpu.ops import common as jax_common
from fuxictr_tpu.ops import mlp as jax_mlp
from fuxictr_tpu.ops.embedding import EmbeddingLayout as JaxLayout
from fuxictr_tpu_torch import config, metrics
from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.data.longctr_loader import (ITEMS_KEY, SEQ_MASK_KEY,
                                                   LongCTRDataLoader)
from fuxictr_tpu_torch.features import FeatureMap
from fuxictr_tpu_torch.models import get_model
from fuxictr_tpu_torch.models.base import resolve_compute_dtype
from fuxictr_tpu_torch.ops.attention import MultiHeadTargetAttention
from fuxictr_tpu_torch.ops.common import get_activation
from fuxictr_tpu_torch.ops.embedding import INVERSE_KEY, EmbeddingLayout
from fuxictr_tpu_torch.ops.mlp import MLP_Block
from fuxictr_tpu_torch.utils.convert import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(ROOT, "configs", "tiny")
DATA = os.path.join(ROOT, "data", "tiny_longctr")
EXPID = "SIM_test"
LOADER_KW = dict(user_info=os.path.join(DATA, "user_info.parquet"),
                 item_info=os.path.join(DATA, "item_info.parquet"))


def _params():
    p = jax_config.load_config(CONFIG_DIR, EXPID)
    p.pop("model")
    return p


def _feature_maps(params):
    fms = []
    for cls in (JaxFeatureMap, FeatureMap):
        fm = cls("tiny_longctr", DATA)
        fm.load(os.path.join(DATA, "feature_map.json"), params)
        fms.append(fm)
    return fms


def _random_like(tree, rng):
    """Seeded stand-ins for trained weights, spread enough that scores and
    predictions vary (the default table init, std 1e-4, leaves every
    prediction at 0.5)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _random_like(val, rng)
            continue
        shape = np.shape(val)
        if key == "kernel":
            arr = rng.normal(0, 1 / np.sqrt(shape[0]), shape)
        elif key.startswith("table_"):
            arr = rng.normal(0, 0.5, shape)
        elif key in ("scale", "var"):
            arr = rng.uniform(0.5, 1.5, shape)
        else:                                       # bias, mean
            arr = rng.normal(0, 0.2, shape)
        out[key] = arr.astype(np.float32)
    return out


def test_load_config_matches_jax():
    assert config.load_config(CONFIG_DIR, EXPID) \
        == jax_config.load_config(CONFIG_DIR, EXPID)


@pytest.mark.parametrize("size_buckets", [None, (8,)])
def test_embedding_layout_matches_jax(size_buckets):
    jfm, tfm = _feature_maps(_params())
    jl, tl = JaxLayout(jfm, 8, size_buckets=size_buckets), \
        EmbeddingLayout(tfm, 8, size_buckets=size_buckets)
    assert tl.tables == jl.tables
    assert {n: (p["table"], p["offset"], p["padding_idx"])
            for n, p in tl.fields.items()} \
        == {n: (p["table"], p["offset"], p["padding_idx"])
            for n, p in jl.fields.items()}


@pytest.mark.parametrize("dedup", [True, False])
def test_loader_batches_match_jax(dedup):
    """batch_size=12 over the 32 valid rows: two full batches and a padded
    one. Dedup orders unique ids differently on the two sides, so the
    expanded ``ids[inv]`` is compared."""
    jfm, tfm = _feature_maps(_params())
    path = os.path.join(DATA, "valid.parquet")
    kw = dict(LOADER_KW, batch_size=12, max_len=12, dedup_items=dedup)
    jb = list(JaxLongCTRLoader(jfm, path, **kw))
    tb = list(LongCTRDataLoader(tfm, path, **kw))
    assert len(jb) == len(tb) == 3
    assert tb[-1][SAMPLE_MASK_KEY].sum() == 8

    def expanded(items, col):
        inv = items.get(INVERSE_KEY)
        return items[col] if inv is None else items[col][inv]

    for j, t in zip(jb, tb):
        for key in ("user_feat", "clk", SEQ_MASK_KEY, SAMPLE_MASK_KEY):
            np.testing.assert_array_equal(t[key], j[key])
        for col in ("item_id", "cate_id"):
            np.testing.assert_array_equal(expanded(t[ITEMS_KEY], col),
                                          expanded(j[ITEMS_KEY], col))


def test_loader_takes_in_memory_tables():
    """The numpy form of the three tables (what chip_smoke.py feeds) gives
    the batches the parquet files give."""
    import pandas as pd
    _, tfm = _feature_maps(_params())
    path = os.path.join(DATA, "valid.parquet")
    tables = [pd.read_parquet(p) for p in (path, LOADER_KW["user_info"],
                                           LOADER_KW["item_info"])]
    from_files = list(LongCTRDataLoader(tfm, path, batch_size=12,
                                        max_len=12, **LOADER_KW))
    in_memory = list(LongCTRDataLoader(
        tfm, {c: tables[0][c].to_numpy() for c in tables[0]},
        batch_size=12, max_len=12,
        user_info=list(tables[1]["full_item_seq"]),
        item_info={c: tables[2][c].to_numpy() for c in tables[2]}))
    assert len(from_files) == len(in_memory) == 3
    for a, b in zip(from_files, in_memory):
        assert a.keys() == b.keys()
        for key in a:
            if key == ITEMS_KEY:
                for col in a[key]:
                    np.testing.assert_array_equal(a[key][col], b[key][col])
            else:
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("element,whitelist", [
    ("user", ()), ("user", ("item",)), ("item", ["item", "user"]),
    ("item", "item"), ("item", "user")])
def test_not_in_whitelist_matches_jax(element, whitelist):
    assert config.not_in_whitelist(element, whitelist) \
        == jax_config.not_in_whitelist(element, whitelist)


def _bf16_tree(tree):
    """Every leaf cast to bfloat16, as ``_predict_body`` casts the params."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                  tree)


def _cast_call(module, dtype, *args):
    """``module(*args)`` on its parameters cast to ``dtype``, buffers as
    they are: what ``RankModel.compute_forward`` does."""
    params = {n: p.to(dtype) for n, p in module.named_parameters()}
    return torch.func.functional_call(module, params, args)


# bf16 tolerance of the layers: the same ops in the same types and order on
# both sides, so at most one bf16 step (2**-7 relative) where a sum taken in
# another order rounds the other way
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}


@pytest.mark.parametrize("num_heads,dtype", [
    pytest.param(1, "float32", id="1"), pytest.param(2, "float32", id="2"),
    pytest.param(1, "bfloat16", id="1-bfloat16"),
    pytest.param(2, "bfloat16", id="2-bfloat16")])
def test_target_attention_layer_matches_jax(num_heads, dtype):
    """In bf16 the JAX layer gets bf16 params, target and history and an
    f32 mask, as in the JAX SIM under compute_dtype=bfloat16."""
    rng = np.random.default_rng(num_heads)
    B, L, d_in, d_att = 6, 9, 16, 8
    x = rng.normal(size=(B, d_in)).astype(np.float32)
    seq = rng.normal(size=(B, L, d_in)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.4).astype(np.float32)
    mask[2] = 0.0                                   # a fully masked row
    layer = jax_attention.MultiHeadTargetAttention(
        input_dim=d_in, attention_dim=d_att, num_heads=num_heads)
    params = layer.init(jax.random.PRNGKey(0), x, seq, mask)["params"]
    params = _random_like(jax.device_get(params), rng)
    port = MultiHeadTargetAttention(d_in, d_att, num_heads)
    port.load_state_dict(params_from_jax(params))
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        params = _bf16_tree(params)
    ref = layer.apply({"params": params}, jnp.asarray(x, dtype),
                      jnp.asarray(seq, dtype), mask)
    with torch.no_grad():
        out = _cast_call(port, tdt, torch.from_numpy(x).to(tdt),
                         torch.from_numpy(seq).to(tdt),
                         torch.from_numpy(mask))
    assert out.dtype == tdt and ref.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=LAYER_TOL[dtype], atol=LAYER_TOL[dtype])


@pytest.mark.parametrize("batch_norm,dtype", [
    pytest.param(False, "float32", id="False"),
    pytest.param(True, "float32", id="True"),
    pytest.param(False, "bfloat16", id="False-bfloat16"),
    pytest.param(True, "bfloat16", id="True-bfloat16")])
def test_mlp_block_matches_jax(batch_norm, dtype):
    """In bf16 the params are cast and the BatchNorm statistics stay f32,
    as ``_predict_body`` leaves the model state."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, 12)).astype(np.float32)
    block = jax_mlp.MLP_Block(hidden_units=(16, 8), output_dim=1,
                              batch_norm=batch_norm)
    variables = jax.device_get(block.init(jax.random.PRNGKey(0), x))
    params = _random_like(variables["params"], rng)
    stats = _random_like(variables.get("batch_stats", {}), rng)
    port = MLP_Block(12, (16, 8), output_dim=1, batch_norm=batch_norm)
    port.load_state_dict(params_from_jax(params, stats))
    port.eval()
    tdt = getattr(torch, dtype)
    if dtype == "bfloat16":
        params = _bf16_tree(params)
    ref = block.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x, dtype))
    with torch.no_grad():
        out = _cast_call(port, tdt, torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt and ref.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=LAYER_TOL[dtype], atol=LAYER_TOL[dtype])


@pytest.mark.parametrize("name", ["relu", "sigmoid", "tanh", "gelu", "elu",
                                  "selu", "silu", "softplus", "leaky_relu",
                                  "identity"])
def test_activation_matches_jax(name):
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    ref = jax_common._SIMPLE_ACTS[name](jnp.asarray(x))
    out = get_activation(name)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module", params=[None, (8,)],
                ids=["one_table", "bucketed"])
def sim_pair(request):
    """The JAX SIM and the port's SIM with the same seeded weights. With
    size buckets (8,) item_id and cate_id sit in different tables, which
    takes the per-field expand path instead of the grouped one."""
    params = _params()
    if request.param is not None:
        params["table_size_buckets"] = request.param
    jfm, tfm = _feature_maps(params)
    jax_model = MODEL_REGISTRY["SIM"](jfm, **params)
    jax_model.init_params()
    weights = _random_like(jax.device_get(jax_model.state.params),
                           np.random.default_rng(2019))
    jax_model.state = jax_model.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, weights))
    tfm.table_size_buckets = request.param
    port = get_model("SIM")(tfm, device="cpu", **params)
    port.load_state_dict(params_from_jax(weights))
    return jax_model, jfm, port, tfm, params


@pytest.mark.parametrize("split,batch_size,dedup", [
    ("train", 16, True), ("valid", 12, True), ("valid", 12, False)])
def test_sim_predict_matches_jax(sim_pair, split, batch_size, dedup):
    jax_model, jfm, port, tfm, params = sim_pair
    path = os.path.join(DATA, f"{split}.parquet")
    kw = dict(LOADER_KW, batch_size=batch_size, max_len=params["max_len"],
              dedup_items=dedup)
    ref = jax_model.predict(JaxLongCTRLoader(jfm, path, **kw))
    out = port.predict(LongCTRDataLoader(tfm, path, **kw))
    assert out.shape == ref.shape and ref.std() > 0.02
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_sim_evaluate_matches_jax(sim_pair):
    jax_model, jfm, port, tfm, params = sim_pair
    path = os.path.join(DATA, "valid.parquet")
    kw = dict(LOADER_KW, batch_size=12, max_len=params["max_len"])
    ref = jax_model.evaluate(JaxLongCTRLoader(jfm, path, **kw),
                             ["AUC", "logloss"])
    out = port.evaluate(LongCTRDataLoader(tfm, path, **kw),
                        ["AUC", "logloss"])
    for key in ("AUC", "logloss"):
        assert abs(out[key] - ref[key]) <= 1e-6, (key, out[key], ref[key])


@pytest.fixture(scope="module")
def sim_bf16(sim_pair):
    """``sim_pair``'s JAX SIM, and a JAX SIM and a port SIM built with
    ``compute_dtype="bfloat16"``, all three on the same weights."""
    jax_model, jfm, port, tfm, params = sim_pair
    params = dict(params, compute_dtype="bfloat16")
    jax_bf16 = MODEL_REGISTRY["SIM"](jfm, **params)
    jax_bf16.init_params()
    jax_bf16.state = jax_bf16.state.replace(params=jax_model.state.params)
    port_bf16 = get_model("SIM")(tfm, device="cpu", **params)
    port_bf16.load_state_dict(port.state_dict())
    return jax_model, jax_bf16, jfm, port_bf16, tfm, params


@pytest.mark.parametrize("split,batch_size,dedup", [
    ("train", 16, True), ("valid", 12, False)])
def test_sim_bf16_predict_matches_jax(sim_bf16, split, batch_size, dedup):
    """``compute_dtype="bfloat16"``: the port's predictions sit closer to
    the JAX package's bf16 predictions than its f32 ones do, by at least
    half: max |port - JAX bf16| <= max |JAX f32 - JAX bf16| / 2 (a port
    that ignores compute_dtype is a whole gap away). The JAX side runs op
    by op (``jax.disable_jit``), so that each op rounds to the type the
    JAX code gives it: under jit, XLA's CPU fusions may keep f32 between
    ops, which no op-by-op framework reproduces. The port runs the same ops
    in the same types, so it also agrees within 1e-5, f32 sums of the
    sigmoid in another order."""
    jax_f32, jax_bf16, jfm, port, tfm, params = sim_bf16
    path = os.path.join(DATA, f"{split}.parquet")
    kw = dict(LOADER_KW, batch_size=batch_size, max_len=params["max_len"],
              dedup_items=dedup)
    with jax.disable_jit():
        ref32 = jax_f32.predict(JaxLongCTRLoader(jfm, path, **kw))
        ref = jax_bf16.predict(JaxLongCTRLoader(jfm, path, **kw))
    out = port.predict(LongCTRDataLoader(tfm, path, **kw))
    gap = np.abs(ref32 - ref).max()
    err = np.abs(out - ref).max()
    assert out.shape == ref.shape and gap > 1e-4
    assert err <= gap / 2, (err, gap)
    assert err <= 1e-5, err


def test_bf16_predict_keeps_f32_master_weights(sim_bf16):
    """A bf16 predict leaves the f32 parameters as they were and reuses one
    cast copy; new weights (``load_state_dict``) refresh it."""
    port, tfm, params = sim_bf16[3:]
    path = os.path.join(DATA, "valid.parquet")
    kw = dict(LOADER_KW, batch_size=12, max_len=params["max_len"])
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    y = port.predict(LongCTRDataLoader(tfm, path, **kw))
    cast = port._compute_params()
    for name, p in port.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, saved[name])
        assert cast[name].dtype == torch.bfloat16
    port.predict(LongCTRDataLoader(tfm, path, **kw))
    assert port._compute_params() is cast
    try:
        port.load_state_dict({k: 2 * v for k, v in saved.items()})
        assert torch.equal(port._compute_params()["W_a.weight"],
                           (2 * saved["W_a.weight"]).bfloat16())
        assert not np.array_equal(
            port.predict(LongCTRDataLoader(tfm, path, **kw)), y)
    finally:
        port.load_state_dict(saved)
    np.testing.assert_array_equal(
        port.predict(LongCTRDataLoader(tfm, path, **kw)), y)


@pytest.mark.parametrize("value,expected", [
    (None, None), ("float32", None), ("fp32", None), (torch.float32, None),
    ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
def test_compute_dtype_values(value, expected):
    """The JAX package's names for f32 compute mean f32 (``None``)."""
    assert resolve_compute_dtype(value) == expected


@pytest.mark.parametrize("value", [
    "float16", "fp16", "float64", "int8", "bfloat", torch.float16])
def test_compute_dtype_that_cannot_be_honoured_raises(value):
    """Nothing is ignored: a type the port's kernels do not take raises,
    at the model's construction too."""
    with pytest.raises(ValueError, match="compute_dtype"):
        resolve_compute_dtype(value)
    _, tfm = _feature_maps(_params())
    with pytest.raises(ValueError, match="compute_dtype"):
        get_model("SIM")(tfm, device="cpu", embedding_dim=4,
                         attention_dim=4, dnn_hidden_units=[8],
                         compute_dtype=value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_sklearn_backed_jax(seed):
    """Scores rounded to two decimals so that many tie; exact 0 and 1 to
    reach the clipping. Tolerance 1e-12: float64 sums in another order."""
    rng = np.random.default_rng(seed)
    n = 500
    y_true = (rng.random(n) < 0.3).astype(np.float64)
    y_pred = np.round(rng.random(n), 2)
    y_pred[:3] = [0.0, 1.0, 1.0]
    ref = jax_metrics.evaluate_metrics(y_true, y_pred, ["AUC", "logloss"])
    out = metrics.evaluate_metrics(y_true, y_pred, ["AUC", "logloss"])
    for key in ("AUC", "logloss"):
        assert abs(out[key] - ref[key]) <= 1e-12, (key, out[key], ref[key])
