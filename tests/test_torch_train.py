"""SIM training in the PyTorch port (``fuxictr_tpu_torch``) against the JAX
package: the gradients of the target attention (K1) and of the deduped
expand (K3), the regularizers, the clip + Adam chain, BatchNorm and dropout
in training, the loss, the loader's shuffle, and the slice as a whole (five
train steps on ``configs/tiny`` ``SIM_test`` over ``data/tiny_longctr``, and
``fit`` with validation and early stop). Inputs come from numpy seeds and go
to both sides; each comparison states its tolerance. Checkpoints are
written under ``tmp_path`` only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import fuxictr_tpu.models.zoo  # noqa: F401  (registers SIM)
from fuxictr_tpu.config import Monitor as JaxMonitor
from fuxictr_tpu.data.longctr_loader import \
    LongCTRDataLoader as JaxLongCTRLoader
from fuxictr_tpu.models.base import RankModel as JaxRankModel
from fuxictr_tpu.models.base import make_optimizer
from fuxictr_tpu.models.registry import MODEL_REGISTRY
from fuxictr_tpu.ops import attention as jax_attention
from fuxictr_tpu.ops import common as jax_common
from fuxictr_tpu.ops import embedding as jax_embedding
from fuxictr_tpu.ops import mlp as jax_mlp
from fuxictr_tpu.ops.pallas_kernels import _xla_target_attention
from fuxictr_tpu_torch.config import Monitor
from fuxictr_tpu_torch.data import SAMPLE_MASK_KEY
from fuxictr_tpu_torch.data.loader import InMemoryDataLoader, RankDataLoader
from fuxictr_tpu_torch.data.longctr_loader import LongCTRDataLoader
from fuxictr_tpu_torch.features import FeatureMap
from fuxictr_tpu_torch.models import get_model
from fuxictr_tpu_torch.models.base import (ClippedAdam,
                                           sigmoid_binary_cross_entropy)
from fuxictr_tpu_torch.ops import embedding as emb
from fuxictr_tpu_torch.ops import target_attention as ta
from fuxictr_tpu_torch.ops.attention import MultiHeadTargetAttention
from fuxictr_tpu_torch.ops.common import Dropout, get_regularizer
from fuxictr_tpu_torch.ops.mlp import MLP_Block
from fuxictr_tpu_torch.utils.convert import params_from_jax
from test_torch_sim import (DATA, LOADER_KW, _bf16_tree, _cast_call,
                            _feature_maps, _params, _random_like)
from test_torch_target_attention import _CudaLike

TOL = 1e-5        # f32: sums and products in another order


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(_np(a))).to(dtype)


# ------------------------------------------------------------------ K1

def _k1_inputs(B, L, D, masked_rows, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((B, D), (B, L, D), (B, L, D), (B, D))]
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[list(masked_rows)] = 0.0
    return arrays, mask


def _k1_grads(B, L, D, masked_rows, dtype):
    """(port, JAX) gradients of q, k, v for the same seeded inputs and
    cotangent, in ``dtype``; JAX op by op (``jax.disable_jit``)."""
    (q, k, v, g), mask = _k1_inputs(B, L, D, masked_rows)
    scale = float(np.sqrt(D))
    jq, jk, jv, jg = (jnp.asarray(a, dtype) for a in (q, k, v, g))
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda a, b, c: _xla_target_attention(
            a, b, c, jnp.asarray(mask), scale), jq, jk, jv)
        ref = [_np(x) for x in vjp(jg)]
    tdt = getattr(torch, dtype)
    tq, tk, tv = (_torch(a, tdt).requires_grad_() for a in (jq, jk, jv))
    out = ta.target_attention(tq, tk, tv, torch.from_numpy(mask), scale)
    grads = torch.autograd.grad(out, (tq, tk, tv), _torch(jg, tdt))
    assert all(x.dtype == tdt for x in grads)
    return [x.float().numpy() for x in grads], ref, _np(jg)


@pytest.mark.parametrize("B,L,D,masked_rows", [
    (8, 64, 16, ()), (6, 40, 16, (0, 3)), (5, 100, 24, (1,))])
def test_target_attention_grads_match_jax(B, L, D, masked_rows):
    """dq, dk, dv of the plain autograd Function against ``jax.vjp`` of
    ``_xla_target_attention`` in f32, within 1e-5. On a fully masked row
    p is 1/L: dv is dout / L at every position, dq and dk are 0."""
    got, ref, g = _k1_grads(B, L, D, masked_rows, "float32")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    dq, dk, dv = got
    for r in masked_rows:
        assert not dq[r].any() and not dk[r].any()
        np.testing.assert_allclose(dv[r], np.broadcast_to(g[r] / L, (L, D)),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,L,D,masked_rows", [
    (8, 30, 16, ()), (6, 24, 16, (0, 3)), (5, 5, 24, (1,))])
def test_target_attention_grads_match_jax_bf16(B, L, D, masked_rows):
    """bf16, against JAX op by op. The plain backward writes out what
    JAX's autodiff of ``jax.nn.softmax`` (``e / s``) computes, with each
    step rounded to bf16 as there, including the sum over L that XLA's CPU
    reduce adds position by position in bf16; measured bitwise equal. (Over
    more than 32 positions XLA's CPU reduce adds in another order, so rows
    that long agree only up to that sum's last bf16 bit.) The tolerance,
    one bf16 step (2**-8) of the largest entry, leaves room for a dot
    product summed in another order."""
    got, ref, _ = _k1_grads(B, L, D, masked_rows, "bfloat16")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2 ** -8 * np.abs(b).max())


@pytest.mark.parametrize("num_heads", [1, 2])
def test_target_attention_layer_grads_match_jax(num_heads):
    """The layer's parameter and input gradients against ``jax.grad`` of
    the flax layer, f32, 1 and 2 heads (the heads reach K1 as contiguous
    ``[B*H, L, Dh]`` copies), a fully masked row included."""
    rng = np.random.default_rng(num_heads)
    B, L, d_in, d_att = 6, 9, 16, 8
    x = rng.normal(size=(B, d_in)).astype(np.float32)
    seq = rng.normal(size=(B, L, d_in)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.4).astype(np.float32)
    mask[2] = 0.0
    ct = rng.normal(size=(B, d_in)).astype(np.float32)
    layer = jax_attention.MultiHeadTargetAttention(
        input_dim=d_in, attention_dim=d_att, num_heads=num_heads)
    params = _random_like(jax.device_get(
        layer.init(jax.random.PRNGKey(0), x, seq, mask)["params"]), rng)

    def loss(p, a, b):
        return jnp.sum(layer.apply({"params": p}, a, b, mask) * ct)

    ref_p, ref_x, ref_seq = jax.grad(loss, argnums=(0, 1, 2))(params, x, seq)
    port = MultiHeadTargetAttention(d_in, d_att, num_heads)
    port.load_state_dict(params_from_jax(params))
    port.train()
    tx, tseq = (torch.from_numpy(a).requires_grad_() for a in (x, seq))
    out = port(tx, tseq, torch.from_numpy(mask))
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                [tx, tseq] + list(port.parameters()))
    np.testing.assert_allclose(grads[0].numpy(), ref_x, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(grads[1].numpy(), ref_seq, rtol=TOL, atol=TOL)
    ref = params_from_jax(jax.device_get(ref_p))
    for name, g in zip(names, grads[2:]):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_attention_dropout_in_training(monkeypatch):
    """attention_dropout > 0 drops attention weights in training on the CPU
    (the plain weights, as the JAX layer does) and raises on CUDA tensors,
    where the kernel has no dropout; eval mode ignores it."""
    rng = np.random.default_rng(3)
    x, seq = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((4, 8), (4, 6, 8)))
    mask = torch.ones(4, 6)
    layer = MultiHeadTargetAttention(
        8, 8, 1, dropout_rate=0.5, generator=torch.Generator().manual_seed(0))
    layer.dropout.generator = torch.Generator().manual_seed(1)
    layer.eval()
    plain = layer(x, seq, mask)
    layer.train()
    dropped = layer(x, seq, mask)
    assert torch.isfinite(dropped).all() and not torch.equal(dropped, plain)
    with pytest.raises(NotImplementedError, match="dropout"):
        layer(x.as_subclass(_CudaLike), seq, mask)


# ------------------------------------------------------------------ K3

def _expand_case(k, seed=0):
    """A loader-like deduped batch: 20 real slots of U = 64 (the rest is
    bucket padding, id 0, which no position names), id 0 also a real slot
    (the history padding item), k fields of one 40-row table whose rows
    coincide across fields."""
    rng = np.random.default_rng(seed)
    V, D, U, used, N = 40, 4, 64, 20, 300
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = np.zeros((k, U), np.int32)
    ids[:, 1:used] = rng.integers(0, V, (k, used - 1))
    mask = ids != 0
    inv = rng.integers(0, used, N).astype(np.int32)
    inv[:40] = 0
    g = rng.normal(size=(N, k * D)).astype(np.float32)
    return table, ids, mask, inv, g


@pytest.mark.parametrize("k", [1, 2, 3])
def test_table_gather_expand_grads_match_jax(k):
    """Forward and table gradient of ``table_gather_expand`` (k = 1) and
    ``table_gather_expand_multi`` against the JAX custom VJPs, f32: the
    forward exactly, the gradient within 1e-6 (sums in another order)."""
    table, ids, mask, inv, g = _expand_case(k)
    if k == 1:
        fn = lambda t: jax_embedding.table_gather_expand(  # noqa: E731
            t, jnp.asarray(ids[0]), jnp.asarray(inv))
    else:
        fn = lambda t: jax_embedding.table_gather_expand_multi(  # noqa: E731
            t, jnp.asarray(ids), jnp.asarray(inv), jnp.asarray(mask))
    out_ref, vjp = jax.vjp(fn, jnp.asarray(table))
    (grad_ref,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_()
    ids_t, inv_t = torch.from_numpy(ids).long(), torch.from_numpy(inv).long()
    out = (emb.table_gather_expand(t, ids_t[0], inv_t) if k == 1 else
           emb.table_gather_expand_multi(t, ids_t, inv_t,
                                         torch.from_numpy(mask)))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_ref))
    (grad,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_ref), rtol=1e-6,
                               atol=1e-6)


def test_expand_backward_takes_the_kernel_for_cuda_gradients(monkeypatch):
    """A CUDA gradient goes to the kernel's wrapper with the forward's ids,
    inv and mask; a CPU one to the plain version."""
    calls = []

    def fake(g, inv, ids_stack, mask_stack, num_rows):
        calls.append((ids_stack.shape, mask_stack is None, num_rows))
        return emb.table_gather_expand_bwd_reference(g, inv, ids_stack,
                                                     mask_stack, num_rows)

    monkeypatch.setattr(emb, "table_gather_expand_bwd_cuda", fake)
    table, ids, mask, inv, g = _expand_case(2)
    t = torch.from_numpy(table).requires_grad_()
    args = (torch.from_numpy(ids).long(), torch.from_numpy(inv).long())
    out = emb.table_gather_expand_multi(t, args[0], args[1],
                                        torch.from_numpy(mask))
    (plain,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    assert not calls
    out = emb.table_gather_expand_multi(t, args[0], args[1],
                                        torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(
        out, t, torch.from_numpy(g).as_subclass(_CudaLike))
    assert calls == [((2, 64), False, 40)]
    torch.testing.assert_close(grad.as_subclass(torch.Tensor), plain,
                               rtol=0, atol=0)


# ------------------------------------------------- regularizers, loss

@pytest.mark.parametrize("reg", [None, 0, 0.0, 1e-3, 2, "l1(0.01)",
                                 "l2(1e-4)", "l1_l2(1e-3,1e-4)",
                                 "l1_l2(1e-3, 1e-4)"])
def test_get_regularizer_matches_jax(reg):
    assert get_regularizer(reg) == jax_common.get_regularizer(reg)


@pytest.mark.parametrize("reg", ["l3(1)", "bogus", [1e-3], {"l2": 1}])
def test_unsupported_regularizer_raises_as_in_jax(reg):
    for parse in (get_regularizer, jax_common.get_regularizer):
        with pytest.raises(NotImplementedError):
            parse(reg)


@pytest.mark.parametrize("emb_reg,net_reg", [
    ("l1_l2(1e-3,1e-4)", 1e-5), (1e-8, 0), (None, "l1(1e-4)"), (None, None)])
def test_regularization_loss_matches_jax(emb_reg, net_reg):
    """On SIM's parameters (the fused tables take the embedding term, the
    rest the net term): within 1e-6 relative, f32 sums in another order."""
    jax_model, _, port, _, _, _ = _sim_models(
        None, embedding_regularizer=emb_reg, net_regularizer=net_reg)
    ref = float(jax_model.regularization_loss(jax_model.state.params))
    out = port.regularization_loss()
    out = float(out) if torch.is_tensor(out) else out
    assert out == pytest.approx(ref, rel=1e-6, abs=1e-12)


def test_sigmoid_bce_matches_optax():
    rng = np.random.default_rng(0)
    logits = np.concatenate([rng.normal(0, 5, 200), [-60.0, 0.0, 60.0]])
    labels = (rng.random(203) < 0.4).astype(np.float32)
    ref = optax.sigmoid_binary_cross_entropy(
        jnp.asarray(logits, jnp.float32), jnp.asarray(labels))
    out = sigmoid_binary_cross_entropy(
        torch.tensor(logits, dtype=torch.float32), torch.from_numpy(labels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("kv,logs", [
    ("AUC", {"AUC": 0.7, "logloss": 0.5}),
    ({"AUC": 1, "logloss": -1}, {"AUC": 0.7, "logloss": 0.5}),
    ({"AUC": 1, "gAUC": 2}, {"AUC": 0.7})])
def test_monitor_matches_jax(kv, logs):
    assert Monitor(kv).get_value(logs) == JaxMonitor(kv).get_value(logs)
    assert Monitor(kv).get_metrics() == JaxMonitor(kv).get_metrics()


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("grad_scale", [0.1, 30.0], ids=["unclipped",
                                                         "clipped"])
def test_clipped_adam_matches_optax(grad_scale):
    """The port's clip + Adam against the JAX package's optax chain over
    six steps of seeded gradients, with the learning rate decayed by 0.1
    after the third (inject_hyperparams in JAX): f32, 1e-6 relative. The
    gradients' global norm is below the clip (10) unclipped, above it
    clipped."""
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 3), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values()))
             for gs in grads]
    assert all((n < 10) == (grad_scale < 1) for n in norms)
    tx = make_optimizer("adam", 1e-3, max_gradient_norm=10.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = ClippedAdam(tparams, 1e-3, max_gradient_norm=10.0)
    for i, gs in enumerate(grads):
        if i == 3:
            node = JaxRankModel._find_hyperparam_nodes(state)[0]
            new_lr = max(float(node.hyperparams["learning_rate"]) * 0.1,
                         1e-6)
            node.hyperparams["learning_rate"] = jnp.asarray(new_lr,
                                                            jnp.float32)
            opt.lr = np.float32(max(float(opt.lr) * 0.1, 1e-6))
        updates, state = tx.update({k: jnp.asarray(v) for k, v in gs.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(gs[k]) for k in shapes])
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------------------------- BatchNorm, dropout

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_flax(dtype):
    """MLP_Block with BatchNorm in training against flax's
    ``BatchNorm(momentum=0.9)``: outputs, and the updated running
    statistics (biased batch variance; the zero rows that pad a batch
    count). ``params_from_jax`` carries the statistics in. f32 within 1e-5;
    bf16 (params cast, statistics f32) within one bf16 step, 2**-7."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(9, 12)).astype(np.float32)
    x[-3:] = 0.0                                     # padding rows
    block = jax_mlp.MLP_Block(hidden_units=(16, 8), output_dim=1,
                              batch_norm=True)
    variables = jax.device_get(block.init(jax.random.PRNGKey(0), x))
    params = _random_like(variables["params"], rng)
    stats = _random_like(variables["batch_stats"], rng)
    port = MLP_Block(12, (16, 8), output_dim=1, batch_norm=True)
    port.load_state_dict(params_from_jax(params, stats))
    port.train()
    jparams = _bf16_tree(params) if dtype == "bfloat16" else params
    ref, new_vars = block.apply({"params": jparams, "batch_stats": stats},
                                jnp.asarray(x, dtype), train=True,
                                mutable=["batch_stats"])
    tdt = getattr(torch, dtype)
    out = _cast_call(port, tdt, torch.from_numpy(x).to(tdt))
    tol = TOL if dtype == "float32" else 2 ** -7
    assert out.dtype == tdt
    np.testing.assert_allclose(out.detach().float().numpy(), _np(ref),
                               rtol=tol, atol=tol)
    want = params_from_jax({}, jax.device_get(new_vars["batch_stats"]))
    for key, val in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(port.state_dict()[key].numpy(),
                                       val.numpy(), rtol=TOL, atol=TOL)


def test_dropout_keeps_one_minus_rate_and_scales():
    """flax's Dropout: kept with probability 1 - rate, scaled by
    1 / (1 - rate), zero elsewhere; the identity in eval mode. The keep
    rate of 200,000 draws lies within 5 standard deviations of 0.7."""
    drop = Dropout(0.3)
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = drop(x)
    kept = y != 0
    sd = np.sqrt(0.3 * 0.7 / x.numel())
    assert abs(float(kept.float().mean()) - 0.7) < 5 * sd
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    drop.eval()
    assert torch.equal(drop(x), x)


# ----------------------------------------------------------- the slice

def _sim_models(size_buckets, compute_dtype=None, **overrides):
    """A JAX SIM and a port SIM on the same seeded weights (fresh
    optimizer states)."""
    params = dict(_params(), **overrides)
    if size_buckets is not None:
        params["table_size_buckets"] = size_buckets
    jfm, tfm = _feature_maps(params)
    params = dict(params, compute_dtype=compute_dtype)
    jax_model = MODEL_REGISTRY["SIM"](jfm, **params)
    jax_model.init_params()
    weights = _random_like(jax.device_get(jax_model.state.params),
                           np.random.default_rng(2019))
    jax_model.state = jax_model.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, weights))
    port = get_model("SIM")(tfm, device="cpu", **params)
    port.load_state_dict(params_from_jax(weights))
    return jax_model, jfm, port, tfm, params, weights


def _train_batches(jfm, tfm, params):
    path = os.path.join(DATA, "train.parquet")
    kw = dict(LOADER_KW, batch_size=16, max_len=params["max_len"])
    return (list(JaxLongCTRLoader(jfm, path, **kw)),
            list(LongCTRDataLoader(tfm, path, **kw)))


def _jax_steps(jax_model, batches, steps):
    """``steps`` JAX train steps; returns the losses and the params."""
    step = jax_model._train_step_body()
    if jax_model._compute_dtype is None:
        step = jax.jit(step)
    state, losses = jax_model.state, []
    for i in range(steps):
        state, loss = step(state, batches[i], jax.random.PRNGKey(i))
        losses.append(float(loss))
    return np.array(losses), params_from_jax(jax.device_get(state.params))


@pytest.mark.parametrize("size_buckets", [None, (8,)],
                         ids=["one_table", "bucketed"])
def test_sim_train_steps_match_jax(size_buckets):
    """Five train steps from the same weights, f32: per-step losses within
    1e-5 relative and every parameter after the last step within 1e-5.
    One table takes ``table_gather_expand_multi`` (item_id and cate_id
    grouped); buckets (8,) split them, each through
    ``table_gather_expand``."""
    jax_model, jfm, port, tfm, params, _ = _sim_models(size_buckets)
    jb, tb = _train_batches(jfm, tfm, params)
    ref_losses, ref_params = _jax_steps(jax_model, jb, 5)
    losses = np.array([float(port.train_step(b)) for b in tb[:5]])
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL)
    state = port.state_dict()
    assert set(ref_params) <= set(state)
    for name, val in ref_params.items():
        np.testing.assert_allclose(state[name].numpy(), val.numpy(),
                                   rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("size_buckets", [None, (8,)],
                         ids=["one_table", "bucketed"])
def test_sim_bf16_train_steps_match_jax(size_buckets):
    """``compute_dtype="bfloat16"``, five steps, against JAX bf16 run op by
    op (``jax.disable_jit``; see test_sim_bf16_predict_matches_jax): the
    port's losses and parameters sit closer to JAX bf16 than JAX f32 does,
    by at least half: max over steps |port - JAX bf16| <= max over steps
    |JAX f32 - JAX bf16| / 2, and the same over every parameter element."""
    jax16, jfm, port, tfm, params, weights = _sim_models(size_buckets,
                                                         "bfloat16")
    jax32 = MODEL_REGISTRY["SIM"](jfm, **dict(params, compute_dtype=None))
    jax32.init_params()
    jax32.state = jax32.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, weights))
    jb, tb = _train_batches(jfm, tfm, params)
    with jax.disable_jit():
        ref_losses, ref_params = _jax_steps(jax16, jb, 5)
    f32_losses, f32_params = _jax_steps(jax32, jb, 5)
    losses = np.array([float(port.train_step(b)) for b in tb[:5]])
    state = port.state_dict()
    loss_gap = np.abs(f32_losses - ref_losses).max()
    assert loss_gap > 1e-5
    assert np.abs(losses - ref_losses).max() <= loss_gap / 2
    gap = max(float((f32_params[n] - v).abs().max())
              for n, v in ref_params.items())
    err = max(float((state[n] - v).abs().max())
              for n, v in ref_params.items())
    assert err <= gap / 2, (err, gap)
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_fit_matches_jax(tmp_path):
    """``fit`` for two epochs with a shuffled train loader, validation
    every two steps, LR decay on plateau and early stop, from the same
    weights: the port and JAX see the same validation AUC and logloss at
    every evaluation (within 1e-5), the same learning rates and the same
    early-stop epoch, and both end on their best saved weights, which
    agree within 1e-4: at this learning rate, 0.03, an Adam step moves a
    weight by up to 0.03 whatever the gradient's size, so f32 differences
    in near-zero gradients show up magnified (measured 3.3e-5 on one of
    896 elements). The port writes ``<model_root>/<dataset_id>/
    SIM_test.pt``, the JAX package ``SIM_test.model`` beside it."""
    overrides = dict(model_root=str(tmp_path), learning_rate=0.03,
                     eval_steps=2, early_stop_patience=2,
                     monitor={"AUC": 1, "logloss": 0})
    jax_model, jfm, port, tfm, params, _ = _sim_models(None, **overrides)
    records = {"jax": [], "port": []}

    def recorder(model, key, lr_of):
        inner = model.checkpoint_and_earlystop

        def wrapped(logs, *args, **kw):
            out = inner(logs, *args, **kw)
            records[key].append((dict(logs), lr_of(), model._epoch_index,
                                 model._stop_training))
            return out
        model.checkpoint_and_earlystop = wrapped

    recorder(jax_model, "jax", lambda: float(
        JaxRankModel._find_hyperparam_nodes(jax_model.state.opt_state)[0]
        .hyperparams["learning_rate"]))
    recorder(port, "port", lambda: float(port.learning_rate))
    kw = dict(LOADER_KW, max_len=params["max_len"])
    paths = {s: os.path.join(DATA, f"{s}.parquet") for s in ("train",
                                                             "valid")}
    np.random.seed(2019)          # the JAX loader shuffles numpy's global
    jax_model.fit(JaxLongCTRLoader(jfm, paths["train"], batch_size=16,
                                   shuffle=True, **kw),
                  validation_data=JaxLongCTRLoader(
                      jfm, paths["valid"], batch_size=16, **kw), epochs=2)
    train_gen, valid_gen = RankDataLoader(
        tfm, stage="train", train_data=paths["train"],
        valid_data=paths["valid"], batch_size=16, shuffle=True,
        data_loader=LongCTRDataLoader, seed=2019, **kw).make_iterator()
    port.fit(train_gen, validation_data=valid_gen, epochs=2)

    ref, out = records["jax"], records["port"]
    assert len(out) == len(ref) >= 3
    assert ref[-1][3] and ref[-1][2] == 1, "JAX should stop in epoch 2"
    for (rlogs, rlr, repoch, rstop), (logs, lr, epoch, stop) in zip(ref, out):
        for key in ("AUC", "logloss"):
            assert abs(logs[key] - rlogs[key]) <= 1e-5, (key, logs, rlogs)
        assert lr == rlr and epoch == repoch and stop == rstop
    assert port.checkpoint == os.path.join(str(tmp_path), "tiny_longctr",
                                           "SIM_test.pt")
    saved = torch.load(port.checkpoint, weights_only=True)
    for name, val in port.state_dict().items():
        assert torch.equal(val, saved[name]), name
    ref_params = params_from_jax(jax.device_get(jax_model.state.params))
    for name, val in ref_params.items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                   val.numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)
    assert sorted(os.listdir(os.path.join(str(tmp_path), "tiny_longctr"))) \
        == ["SIM_test.model", "SIM_test.pt"]


# ------------------------------------------------------------- loading

def test_shuffle_matches_jax_global_shuffle():
    """Two epochs of the port's shuffled loader (its own RandomState(seed))
    against the JAX loader after ``np.random.seed(seed)``: the same rows
    in every batch."""
    jfm, tfm = _feature_maps(_params())
    path = os.path.join(DATA, "train.parquet")
    kw = dict(LOADER_KW, batch_size=16, max_len=12, shuffle=True)
    port = LongCTRDataLoader(tfm, path, seed=2019, **kw)
    jax_loader = JaxLongCTRLoader(jfm, path, **kw)
    np.random.seed(2019)
    for _ in range(2):
        for j, t in zip(jax_loader, port):
            np.testing.assert_array_equal(t["user_feat"], j["user_feat"])
            np.testing.assert_array_equal(t["clk"], j["clk"])


@pytest.mark.parametrize("stage", ["train", "test", "both"])
def test_rank_data_loader_stages(stage):
    _, tfm = _feature_maps(_params())
    paths = {f"{s}_data": os.path.join(DATA, f"{s}.parquet")
             for s in ("train", "valid", "test")}
    out = RankDataLoader(tfm, stage=stage, batch_size=16, max_len=12,
                         data_loader=LongCTRDataLoader, **paths,
                         **LOADER_KW).make_iterator()
    if stage == "test":
        assert out.num_samples == 32 and not out.shuffle
    else:
        train, valid = out[0], out[1]
        assert train.shuffle and not valid.shuffle
        assert (train.num_samples, valid.num_samples) == (96, 32)
        if stage == "both":
            assert out[2].num_samples == 32


def test_rank_data_loader_refuses_what_is_not_ported():
    """A loader named by a string and the device-cache loader raise; no
    ``data_loader`` now gives the in-memory loader, as in the JAX facade
    (it refused until the in-memory loader was ported)."""
    _, tfm = _feature_maps(_params())
    with pytest.raises(NotImplementedError, match="LongCTRDataLoader"):
        RankDataLoader(tfm, stage="test", test_data="x",
                       data_loader="LongCTRDataLoader")
    with pytest.raises(NotImplementedError, match="device-cache"):
        RankDataLoader(tfm, stage="test", test_data="x",
                       data_loader=LongCTRDataLoader, device_cache=True)
    tiny = os.path.join(os.path.dirname(DATA), "tiny_parquet")
    fm = FeatureMap("tiny_parquet", tiny)
    fm.load(os.path.join(tiny, "feature_map.json"))
    test_gen = RankDataLoader(fm, stage="test", batch_size=16,
                              test_data=os.path.join(tiny, "test.parquet"),
                              data_loader=None).make_iterator()
    assert isinstance(test_gen, InMemoryDataLoader)
    assert test_gen.num_samples == 100 and not test_gen.shuffle


def _small_sim_and_batch(**override):
    _, tfm = _feature_maps(_params())
    model = get_model("SIM")(tfm, device="cpu", embedding_dim=4,
                             attention_dim=4, dnn_hidden_units=[8],
                             short_seq_len=4, topk=5, **override)
    batch = next(iter(LongCTRDataLoader(
        tfm, os.path.join(DATA, "valid.parquet"), batch_size=8, max_len=12,
        **LOADER_KW)))
    return model, batch


@pytest.mark.parametrize("override,match", [
    (dict(optimizer="sgd"), "optimizer"),
    (dict(lazy_adam=True), "lazy_adam"),
    (dict(periodic_ckpt=1), "periodic_ckpt")])
def test_training_features_not_ported_raise(override, match):
    model, batch = _small_sim_and_batch(**override)
    with pytest.raises(NotImplementedError, match=match):
        model.train_step(batch)
    assert float(np.asarray(batch[SAMPLE_MASK_KEY]).sum()) == 8


def test_sim_ignores_accumulation_steps_as_jax_does():
    """SIM takes ``accumulation_steps`` by name and drops it, as the JAX
    SIM does (its RankModel reads the value only from kwargs): five train
    steps with ``accumulation_steps=2`` match the JAX SIM's within 1e-5
    (losses relative, parameters absolute), and are bitwise the port's own
    run with ``accumulation_steps=1``."""
    jax_model, jfm, port, tfm, params, _ = _sim_models(
        None, accumulation_steps=2)
    assert "accumulation_steps" not in port.kwargs
    jb, tb = _train_batches(jfm, tfm, params)
    ref_losses, ref_params = _jax_steps(jax_model, jb, 5)
    losses = [port.train_step(b) for b in tb[:5]]
    np.testing.assert_allclose([float(x) for x in losses], ref_losses,
                               rtol=TOL)
    state = port.state_dict()
    for name, val in ref_params.items():
        np.testing.assert_allclose(state[name].numpy(), val.numpy(),
                                   rtol=0, atol=TOL, err_msg=name)
    once = _sim_models(None, accumulation_steps=1)[2]
    once_losses = [once.train_step(b) for b in tb[:5]]
    assert all(torch.equal(a, b) for a, b in zip(losses, once_losses))
    for name, val in once.state_dict().items():
        assert torch.equal(state[name], val), name


def test_accumulation_steps_in_kwargs_still_raises():
    """A model whose RankModel receives ``accumulation_steps > 1`` (as the
    JAX package's DNN does through ``**kwargs``) still refuses to train:
    optax ``MultiSteps`` is not ported."""
    model, batch = _small_sim_and_batch()
    model.kwargs["accumulation_steps"] = 2
    with pytest.raises(NotImplementedError, match="accumulation_steps"):
        model.train_step(batch)
