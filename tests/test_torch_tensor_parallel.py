"""The port's tensor parallelism (``gigapath_tpu_torch/parallel/tensor.py``,
``model_group=`` of the attention, the FFN and the encoder, and
``parallel/spmd.py:make_train_step`` over a ``model`` and a ``seq`` dim)
held against the JAX package on the CPU.

- The op: a rank's heads ``[j*H/T, (j+1)*H/T)`` of ``dilated_attention``
  (``head_offset``, ``num_heads``) at H = 8 over T = 4 ranks, on the
  schedule ``[8, 16, 32, 64] / [1, 2, 4, 8]`` (r <= T and r > H/T both
  occur: a rank's heads share one phase or span two), 37 of 50 tokens
  valid, forward and gradients against JAX's single-device op on those
  heads (1e-5).
- The step: eight gloo ranks (``tests/torch_rank_bodies.py``) train JAX's
  test head (16 heads, branches ``[8, 32] / [1, 16]``: r = 16 > H/T
  for T = 2 and 4, r = 1 on the flat kernel's route) on meshes ``{data 4, model 2}`` and ``{data 2,
  model 4}`` (every data rank on the whole batch: a ``{model 2}`` and a
  ``{model 4}`` step) and ``{data 2, seq 2, model 2}``; each step's loss
  (rtol 1e-5) and gradients gathered over the model group (atol 2e-5)
  against JAX's single-device step and JAX's own ``{data 2, seq 2, model
  2}`` step, as ``tests/test_parallel.py``.
- Dropout in training mode: the ranks of a model group draw the same
  residual-stream masks, and the tensor-parallel head equals the
  one-device head after the same seed.
- The state-dict cut and its inverse, and the refusals.

The slow parts (the JAX references' compiles, the rank processes) all
start in the module's first fixture, in threads, and each test waits for
the one it reads.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

import torch_rank_bodies as rb
from gigapath_tpu.models.classification_head import ClassificationHead as JaxHead
from gigapath_tpu.ops import dilated_attention as jda
from gigapath_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigapath_tpu.parallel.mesh import shard_batch_seq
from gigapath_tpu.parallel.sharding import apply_shardings
from gigapath_tpu_torch.models.classification_head import ClassificationHead
from gigapath_tpu_torch.models.streaming_encoder import check_streamable
from gigapath_tpu_torch.ops import dilated_attention as pda
from gigapath_tpu_torch.parallel import tensor as tp
from gigapath_tpu_torch.utils.convert import flax_params_from_state_dict, state_dict_for_rank, state_dict_from_flax_params

# The JAX references compile with LLVM's optimisations off: the same
# function and the same fp32 arithmetic, in about a third of the compile
# time, which is most of these tests' cost.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _jitted(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


OP_H, OP_T, OP_DH = 8, 4, 4
OP_SCHEDULE = ([8, 16, 32, 64], [1, 2, 4, 8])
OP_CASES = ((50, 37),)  # (L, valid tokens): every branch masked (the dense route is the step's)


def _op_inputs(L):
    rng = np.random.default_rng(0)
    return [rng.normal(size=(1, L, OP_H, OP_DH)).astype(np.float32) for _ in range(4)]


def _jax_op():
    """JAX's single-device op on every ``OP_CASES`` case, forward and the
    gradients of ``sum(out * ct)``, in one jitted call."""
    sls, drs = OP_SCHEDULE

    def run():
        out = {}
        for L, valid in OP_CASES:
            q, k, v, ct = (jnp.asarray(x) for x in _op_inputs(L))
            vl = None if valid is None else jnp.asarray([valid])

            def loss(q, k, v, ct=ct, vl=vl):
                o = jda.dilated_attention(q, k, v, sls, drs, valid_len=vl)
                return (o * ct).sum(), o

            out[L] = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        return out

    return jax.device_get(_jitted(run))


@pytest.mark.parametrize("L,valid", OP_CASES)
def test_rank_heads_match_jax_single_device_op(jobs, L, valid):
    """Each of T = 4 ranks' 2 heads through the tensor-parallel route
    equals JAX's single-device op on those heads, forward and the gradients
    of a seeded cotangent; the route is the head-major one at the global
    phases (``_phase_head_ranges`` against JAX's ``arange(H) //
    ceil(H/r)``)."""
    q, k, v, ct = _op_inputs(L)
    sls, drs = OP_SCHEDULE
    (_, ref), grads = jobs["op"].result()[L]
    per = OP_H // OP_T
    for j in range(OP_T):
        heads = slice(j * per, (j + 1) * per)
        local = [torch.from_numpy(np.ascontiguousarray(x[:, :, heads])).requires_grad_(True) for x in (q, k, v)]
        out = pda.dilated_attention(*local, sls, drs, head_offset=j * per, num_heads=OP_H,
                                    valid_len=None if valid is None else torch.tensor([valid]))
        (out * torch.from_numpy(np.ascontiguousarray(ct[:, :, heads]))).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref)[:, :, heads], atol=1e-5, rtol=1e-5)
        for g, x in zip(grads, local):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(g)[:, :, heads], atol=1e-5, rtol=1e-5)
        for r in drs:
            jax_phase = np.arange(OP_H) // -(-OP_H // r)
            for p, hs, he in pda._phase_head_ranges(per, r, (j * per, OP_H)):
                assert (jax_phase[j * per + hs: j * per + he] == p).all()


def _batch():
    rng = np.random.default_rng(3)
    return {
        "images": rng.normal(size=(rb.TP_B, rb.TP_N, rb.TP_HEAD["input_dim"])).astype(np.float32),
        "coords": rng.uniform(0, 25000, (rb.TP_B, rb.TP_N, 2)).astype(np.float32),
        "labels": np.array([0, 2], np.int64),
    }


def _head_state():
    torch.manual_seed(0)
    rng = np.random.default_rng(4)  # non-trivial norms and biases
    return {k: v + torch.from_numpy(0.05 * rng.normal(size=tuple(v.shape)).astype(np.float32))
            for k, v in ClassificationHead(**rb.TP_HEAD, **rb.TP_SLIDE).state_dict().items()}


def _jax_steps(state):
    """JAX's loss and gradients (state-dict names) of the head's step on
    one device and on its ``{data 2, seq 2, model 2}`` mesh of CPU
    devices: ``{"single": ..., "data2_seq2_model2": ...}``. One step
    function serves both, so the second lowering reuses the first's
    trace."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jhead = JaxHead(**rb.TP_HEAD, slide_kwargs=rb.TP_SLIDE)
    params = flax_params_from_state_dict(state)
    batch = {k: jnp.asarray(v.astype(np.int32) if k == "labels" else v) for k, v in _batch().items()}

    def loss_fn(p, b):
        logits = jhead.apply({"params": p}, b["images"], b["coords"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, b["labels"][:, None], axis=-1).mean()

    step = jax.jit(jax.value_and_grad(loss_fn))
    out = {"single": step.lower(params, batch).compile(compiler_options=FAST_COMPILE)(params, batch)}
    mesh = jax_make_mesh(8, axis_sizes={"data": 2, "seq": 2, "model": 2})
    with mesh:
        sharded = {"images": jax.device_put(batch["images"], shard_batch_seq(mesh)),
                   "coords": jax.device_put(batch["coords"], shard_batch_seq(mesh)),
                   "labels": jax.device_put(batch["labels"], NamedSharding(mesh, P("data")))}
        laid = apply_shardings(params, mesh)
        out["data2_seq2_model2"] = step.lower(laid, sharded).compile(compiler_options=FAST_COMPILE)(laid, sharded)
    return {name: (float(loss), state_dict_from_flax_params(jax.device_get(grads)))
            for name, (loss, grads) in out.items()}


def _ranks(work: str, state):
    torch.save(state, f"{work}/head_state.pt")
    np.savez(f"{work}/batch.npz", **_batch())
    return rb.join_ranks(rb.start_ranks(rb.tensor_parallel_rank, rb.TP_WORLD, work), work)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The module's slow parts, started at once in threads: the eight
    ranks, and JAX's op and its single-device and ``{data 2, seq 2, model
    2}`` steps on the same weights and batch. ``{name: future}``."""
    work = str(tmp_path_factory.mktemp("tensor_parallel"))
    state = _head_state()  # here: torch's global generator is not for threads to share
    pool = ThreadPoolExecutor(max_workers=4)
    futures = {"ranks": pool.submit(_ranks, work, state), "steps": pool.submit(_jax_steps, state),
               "op": pool.submit(_jax_op)}
    futures["state"] = pool.submit(lambda: state)
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def runs(jobs):
    return jobs["steps"].result(), jobs["state"].result(), _batch(), jobs["ranks"].result()


@pytest.mark.parametrize("mesh", list(rb.TP_MESHES))
@pytest.mark.parametrize("against", ["single", "data2_seq2_model2"])
def test_tp_step_matches_jax(runs, mesh, against):
    """The loss on every rank (rtol 1e-5) and every parameter's gradient,
    gathered over the model group (atol 2e-5), against JAX's step."""
    jax_side, state, _, ranks = runs
    jloss, jgrads = jax_side[against]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{mesh}_loss"]), jloss, rtol=1e-5)
    grads = {k[len(f"{mesh}_grad_"):]: v for k, v in ranks[0].items() if k.startswith(f"{mesh}_grad_")}
    assert set(grads) == set(state) == set(jgrads)
    for name, g in grads.items():
        assert g.shape == tuple(state[name].shape), name
        np.testing.assert_allclose(g, jgrads[name].numpy(), atol=2e-5, err_msg=name)


def test_tp_dropout_masks_agree_across_ranks_and_with_one_device(runs):
    """Dropout 0.25 in training mode after one seed: both ranks of each
    model group give the same logits (the residual-stream masks agree,
    the sharded activation's mask is the whole width's), equal to the
    one-device head's (the same draws)."""
    _, state, _, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["dropout_tp"], ranks[0]["dropout_tp"], atol=0, rtol=0)
        np.testing.assert_allclose(r["dropout_tp"], r["dropout_single"], atol=1e-5, rtol=1e-5)
    without = ClassificationHead(**rb.TP_HEAD, **rb.TP_SLIDE)
    without.load_state_dict(state)
    with torch.no_grad():
        plain = without.eval()(*(torch.from_numpy(_batch()[k]) for k in ("images", "coords"))).numpy()
    assert not np.allclose(ranks[0]["dropout_single"], plain)  # the masks acted


@pytest.mark.parametrize("case,exc", [("seq_and_model", "ValueError"), ("op_seq_and_heads", "ValueError"),
                                      ("heads_not_divisible", "ValueError"), ("ffn_not_divisible", "ValueError"),
                                      ("moe_and_model", "ValueError")])
def test_tp_refusals(runs, case, exc):
    _, _, _, ranks = runs
    assert [str(r[f"refusal_{case}"]) for r in ranks] == [exc] * rb.TP_WORLD


def test_streaming_refuses_a_tensor_parallel_model():
    from gigapath_tpu_torch.architecture.config import EncoderConfig

    cfg = EncoderConfig(segment_length=[8], dilated_ratio=[1])
    cfg.extras["model_group"] = object()
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        check_streamable(cfg)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_and_gather_state_dict(world):
    """The cut follows ``param_spec``'s column and row rules on the
    tensor-parallel modules (q/k/v/fc1 weights and biases by rows,
    out_proj/fc2 weights by columns), the sub-LNs by their width, and
    keeps the patch embed, pre-LNs, row biases and head whole; the gather
    is its inverse, and ``state_dict_for_rank`` cuts a JAX tree alike."""
    state = _head_state()
    parts = [tp.shard_state_dict(state, r, world) for r in range(world)]
    enc = "slide_encoder.encoder.layers.0."
    want = {f"{enc}self_attn.q_proj.weight": 0, f"{enc}self_attn.v_proj.bias": 0,
            f"{enc}self_attn.out_proj.weight": 1, f"{enc}self_attn.inner_attn_ln.weight": 0,
            f"{enc}ffn.fc1.weight": 0, f"{enc}ffn.fc2.weight": 1, f"{enc}ffn.ffn_layernorm.bias": 0}
    whole = [f"{enc}self_attn.out_proj.bias", f"{enc}ffn.fc2.bias", f"{enc}self_attn_layer_norm.weight",
             "slide_encoder.patch_embed.proj.weight", "classifier.weight"]
    for name, dim in want.items():
        for r in range(world):
            torch.testing.assert_close(parts[r][name], state[name].chunk(world, dim=dim)[r], rtol=0, atol=0)
    for name in whole:
        assert all(p[name] is state[name] for p in parts)
    back = tp.gather_state_dict(parts)
    assert set(back) == set(state)
    for name, t in state.items():
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)
    tree = flax_params_from_state_dict(state)
    for r in range(world):
        got = state_dict_for_rank(tree, r, world)
        for name, t in parts[r].items():
            torch.testing.assert_close(got[name], t, rtol=0, atol=0)
