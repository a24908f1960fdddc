"""The port's mixture of experts (``gigapath_tpu_torch/ops/moe/``, the
encoder's MoE hook, ``collect_moe_l_aux``, ``moe_scalars``, the MoE
parameters' conversion and layout) and its expert parallelism, held
against the JAX package on the CPU (forward 1e-5, gradients 1e-4).

- ``top1_gating`` and ``top2_gating`` against ``routing.py`` on seeded
  logits: capacity, dispatch, combine, balance loss and metadata, padding,
  the eval capacity, batch-prioritised routing; top-2's ``"sampling"`` and
  ``"random"`` policies fed JAX's own noise; the xmoe cosine router.
- ``MOELayer`` (top-1 and top-2, in eval and in training mode with JAX's
  draw) and an MoE ``Encoder`` (``moe_freq=2``): output, ``l_aux`` and
  every gradient.
- Expert parallelism over four gloo ranks (``tests/torch_rank_bodies.py``):
  the single-device variant against JAX's unsharded layer (the expectation
  of JAX's GSPMD test) and per-shard gating against JAX's ``shard_map``
  choreography (``moe_expert_parallel``), forward, ``l_aux`` and
  gradients.
- ``dryrun.dryrun_multichip(4, device="cpu")``.

The slow parts (the JAX references' compiles, the rank processes, the dry
run's processes) all start in the module's first fixture, in threads, and
each test waits for the one it reads.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

import torch_rank_bodies as rb
from gigapath_tpu.architecture.config import EncoderConfig as JaxEncoderConfig
from gigapath_tpu.architecture.encoder import Encoder as JaxEncoder
from gigapath_tpu.obs.telemetry import moe_scalars as jax_moe_scalars
from gigapath_tpu.ops.moe import moe_layer as jax_moe_layer
from gigapath_tpu.ops.moe import routing as jr
from gigapath_tpu.ops.moe.expert_parallel import moe_expert_parallel as jax_moe_expert_parallel
from gigapath_tpu.parallel.mesh import make_mesh as jax_make_mesh
from gigapath_tpu.parallel.spmd import collect_moe_l_aux as jax_collect_moe_l_aux
from gigapath_tpu_torch.architecture.config import EncoderConfig
from gigapath_tpu_torch.architecture.encoder import Encoder
from gigapath_tpu_torch.dist.stagemesh import stage_param_specs
from gigapath_tpu_torch.dryrun import dryrun_multichip
from gigapath_tpu_torch.ops.moe import MOELayer
from gigapath_tpu_torch.ops.moe import routing as pr
from gigapath_tpu_torch.obs.telemetry import moe_scalars
from gigapath_tpu_torch.parallel.sharding import param_spec
from gigapath_tpu_torch.parallel.spmd import collect_moe_l_aux
from gigapath_tpu_torch.parallel.tensor import shard_state_dict
from gigapath_tpu_torch.utils.convert import flax_params_from_state_dict, state_dict_from_flax_params
from gigapath_tpu_torch.utils.profiling import collect_moe_metadata


# The JAX references compile with LLVM's optimisations off: the same
# function and the same fp32 arithmetic, in about a third of the compile
# time, which is most of these tests' cost.
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _jitted(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _check_gating(got, want, fwd=1e-5):
    l_aux, combine, dispatch, meta = got
    jl, jc, jd, jm = want
    np.testing.assert_allclose(_np(l_aux), np.asarray(jl), rtol=fwd, atol=fwd)
    np.testing.assert_allclose(_np(combine), np.asarray(jc), rtol=fwd, atol=fwd)
    np.testing.assert_array_equal(_np(dispatch), np.asarray(jd))
    assert set(meta) == set(jm)
    for key in jm:
        np.testing.assert_allclose(_np(meta[key]).astype(np.float64), np.asarray(jm[key]).astype(np.float64),
                                   rtol=fwd, atol=fwd, err_msg=key)


def _logits(S, E, seed=0):
    return np.random.default_rng(seed).normal(size=(S, E)).astype(np.float32)


TOP1_CASES = {
    "capacity_factor": dict(S=16, E=4, kw=dict(capacity_factor=0.5)),
    "eval_capacity": dict(S=16, E=2, kw=dict(eval_mode=True, eval_capacity_token_fraction=0.25)),
    "padding": dict(S=12, E=3, kw={}, pad=7),
}
TOP2_S, TOP2_E = 24, 4
TOP2_CASES = {
    "deterministic": dict(kw={}),
    "sampling": dict(kw=dict(second_expert_policy="sampling"), noise="gumbel"),
    "random": dict(kw=dict(second_expert_policy="random"), noise="uniform"),
    "normalize_before_dropping": dict(kw=dict(second_expert_policy="random",
                                              normalize_gate_prob_before_dropping=True), noise="uniform"),
    "prioritized_eval": dict(kw=dict(batch_prioritized_routing=True, eval_mode=True)),
    "padding": dict(kw=dict(second_expert_policy="sampling"), noise="gumbel", pad=17),
}


def _pad_mask(S, start):
    return None if start is None else np.arange(S) >= start


def _jax_gating():
    """Every gating case's JAX result, and top-2's draws from
    ``PRNGKey(5)`` (the Gumbel sample of ``"sampling"``, the uniform one of
    ``"random"``), in one jitted call."""

    def run():
        out = {}
        for name, c in TOP1_CASES.items():
            mask = _pad_mask(c["S"], c.get("pad"))
            out[f"top1_{name}"] = jr.top1_gating(jnp.asarray(_logits(c["S"], c["E"])),
                                                 None if mask is None else jnp.asarray(mask), **c["kw"])
        key = jax.random.PRNGKey(5)
        for name, c in TOP2_CASES.items():
            mask = _pad_mask(TOP2_S, c.get("pad"))
            out[f"top2_{name}"] = jr.top2_gating(
                jnp.asarray(_logits(TOP2_S, TOP2_E, seed=1)), None if mask is None else jnp.asarray(mask),
                rng=key if "noise" in c else None, **c["kw"])
        out["gumbel"] = jax.random.gumbel(key, (TOP2_S, TOP2_E), jnp.float32)
        out["uniform"] = jax.random.uniform(key, (TOP2_S,), jnp.float32)
        return out

    return jax.device_get(_jitted(run))


@pytest.mark.parametrize("case", list(TOP1_CASES))
def test_top1_gating_matches_jax(jobs, case):
    jax_gating = jobs["gating"].result()
    c = TOP1_CASES[case]
    mask = _pad_mask(c["S"], c.get("pad"))
    got = pr.top1_gating(torch.from_numpy(_logits(c["S"], c["E"])),
                         None if mask is None else torch.from_numpy(mask), **c["kw"])
    _check_gating(got, jax_gating[f"top1_{case}"])


@pytest.mark.parametrize("case", list(TOP2_CASES))
def test_top2_gating_matches_jax_with_jax_noise(jobs, case):
    """The stochastic policies take JAX's own draw."""
    jax_gating = jobs["gating"].result()
    c = TOP2_CASES[case]
    mask = _pad_mask(TOP2_S, c.get("pad"))
    noise = torch.from_numpy(np.array(jax_gating[c["noise"]])) if "noise" in c else None
    got = pr.top2_gating(torch.from_numpy(_logits(TOP2_S, TOP2_E, seed=1)),
                         None if mask is None else torch.from_numpy(mask), noise=noise, **c["kw"])
    _check_gating(got, jax_gating[f"top2_{case}"])


def test_top2_generator_draws_are_reproducible():
    logits = torch.from_numpy(_logits(32, 4, seed=2))
    a = pr.top2_gating(logits, generator=torch.Generator().manual_seed(3))[1]
    b = pr.top2_gating(logits, generator=torch.Generator().manual_seed(3))[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


XMOE_X = np.random.default_rng(4).normal(size=(12, 16)).astype(np.float32)


def _jax_xmoe():
    """JAX's xmoe top-1 and top-2 gates on one set of weights: the weights
    and both gatings."""
    x = jnp.asarray(XMOE_X)
    gates = {top1: (jr.Top1Gate if top1 else jr.Top2Gate)(model_dim=16, num_experts=4, use_xmoe=True)
             for top1 in (True, False)}

    def run():
        params = gates[True].init(jax.random.PRNGKey(0), x)["params"]
        return params, {top1: g.apply({"params": params}, x) for top1, g in gates.items()}

    return jax.device_get(_jitted(run))


def test_xmoe_gate_logits_and_gating_match_jax(jobs):
    """The cosine router (``wg_reduction`` and the normalised ``wg``), top-1
    and top-2 gates on one set of weights."""
    params, want = jobs["xmoe"].result()
    state = state_dict_from_flax_params(params)
    for top1 in (True, False):
        port = (pr.Top1Gate if top1 else pr.Top2Gate)(16, 4, use_xmoe=True)
        port.load_state_dict(state, strict=True)
        _check_gating(port(torch.from_numpy(XMOE_X), eval_mode=True), want[top1])


LAYER_CASES = {"top1_eval": (True, False, {}),
               "top2_train_sampling": (False, True, dict(second_expert_policy="sampling")),
               "top2_train_random_subln": (False, True, dict(second_expert_policy="random", subln=True))}
LAYER_X = np.random.default_rng(6).normal(size=(2, 8, 16)).astype(np.float32)
LAYER_CT = np.random.default_rng(7).normal(size=(2, 8, 16)).astype(np.float32)
LAYER_PAD = np.arange(8)[None, :] >= np.array([[8], [5]])


def _jax_layers():
    """Every layer case's JAX parameters, output, ``l_aux`` and gradients
    of ``sum(out * ct) + 0.1 * l_aux``, and in training mode the gate's
    noise (caught at ``jax.random`` while the layer draws it, in this
    thread only), in one jitted call."""
    drawn = []
    owner = threading.get_ident()

    def spy(real):
        def draw(*a, **k):
            value = real(*a, **k)
            if threading.get_ident() == owner:
                drawn.append(value)
            return value

        return draw

    def run():
        out = {}
        x = jnp.asarray(LAYER_X)
        for name, (top1, train, kw) in LAYER_CASES.items():
            layer = jax_moe_layer.MOELayer(embed_dim=16, ffn_dim=32, num_experts=4, top1=top1, **kw)
            params = layer.init(jax.random.PRNGKey(0), x)["params"]
            del drawn[:]

            def loss(p, x, layer=layer, train=train):
                o, l_aux = layer.apply({"params": p}, x, jnp.asarray(LAYER_PAD), not train,
                                       rngs={"dropout": jax.random.PRNGKey(9)} if train else None)
                return (o * LAYER_CT).sum() + 0.1 * l_aux, (o, l_aux)

            (_, (o, l_aux)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
            out[name] = dict(params=params, out=o, l_aux=l_aux, grads=grads,
                             noise=drawn[0] if train else jnp.zeros(()))
        return out

    with pytest.MonkeyPatch.context() as mp:
        for name in ("gumbel", "uniform"):
            mp.setattr(jr.jax.random, name, spy(getattr(jr.jax.random, name)))
        return jax.device_get(_jitted(run))


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax(jobs, case):
    """Output and ``l_aux`` (1e-5) and every gradient of ``sum(out * ct) +
    0.1 * l_aux`` (1e-4); in training mode the gate's noise is the one
    JAX's layer drew."""
    top1, train, kw = LAYER_CASES[case]
    want = jobs["layers"].result()[case]
    port = MOELayer(embed_dim=16, ffn_dim=32, num_experts=4, top1=top1, **kw)
    port.load_state_dict(state_dict_from_flax_params(want["params"]), strict=True)
    port.train(train)
    xt = torch.from_numpy(LAYER_X.copy()).requires_grad_(True)
    noise = torch.from_numpy(np.array(want["noise"])) if train else None
    out, l_aux = port(xt, torch.from_numpy(LAYER_PAD), noise=noise)
    ((out * torch.from_numpy(LAYER_CT)).sum() + 0.1 * l_aux).backward()
    np.testing.assert_allclose(_np(out), np.asarray(want["out"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(l_aux), np.asarray(want["l_aux"]), atol=1e-5, rtol=1e-5)
    jgp, jgx = want["grads"]
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4, rtol=1e-4)
    grads = state_dict_from_flax_params(jgp)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    assert set(port.metadata) and all(v.dim() == 0 for v in port.metadata.values())


ENC_CFG = dict(encoder_embed_dim=16, encoder_attention_heads=2, encoder_ffn_embed_dim=32, encoder_layers=2,
               moe_freq=2, moe_expert_count=4, moe_top1_expert=True)


def _jax_encoder():
    """JAX's MoE encoder: its parameters, and its output, summed ``l_aux``,
    intermediates and gradients of ``var(out) + 0.01 * l_aux`` (JAX's test
    objective), in one jitted call; the port's encoder on those weights."""
    jenc = JaxEncoder(JaxEncoderConfig(**ENC_CFG, vocab_size=-1, no_output_layer=True))
    x = jnp.asarray(np.random.default_rng(8).normal(size=(2, 8, 16)).astype(np.float32))

    def run():
        params = jenc.init(jax.random.PRNGKey(0), token_embeddings=x)["params"]

        def loss(p):
            out, mods = jenc.apply({"params": p}, token_embeddings=x, mutable=["intermediates"])
            l_aux = jax_collect_moe_l_aux(mods["intermediates"])
            return out["encoder_out"].var() + 0.01 * l_aux, (out["encoder_out"], l_aux, mods["intermediates"])

        return params, jax.value_and_grad(loss, has_aux=True)(params)

    params, ((_, aux), grads) = jax.device_get(_jitted(run))
    port = Encoder(EncoderConfig(**ENC_CFG))
    port.load_state_dict(state_dict_from_flax_params(params), strict=True)
    return params, aux, grads, port.eval(), np.array(x)


def test_moe_encoder_matches_jax(jobs):
    """The MoE encoder (layer 1 MoE): ``encoder_out`` and the summed
    ``l_aux`` (``collect_moe_l_aux``) (1e-5), and every gradient of
    ``var(out) + 0.01 * l_aux`` (1e-4), JAX's test objective (the biased
    variance, as ``jnp.var``)."""
    params, (jout, jaux, inter), jgrads, port, x = jobs["encoder"].result()
    port.zero_grad(set_to_none=True)
    out = port(torch.from_numpy(x))
    l_aux = collect_moe_l_aux(port)
    assert out["l_aux"][0] is None and out["l_aux"][1] is not None
    (out["encoder_out"].var(correction=0) + 0.01 * l_aux).backward()
    np.testing.assert_allclose(_np(out["encoder_out"]), np.asarray(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(l_aux), np.asarray(jaux), atol=1e-5, rtol=1e-5)
    want = state_dict_from_flax_params(jgrads)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4, err_msg=name)
    # the gating telemetry: JAX's keys, and its values
    jtel = jax_moe_scalars(inter)  # on host values: the keys and the leaves
    tel = moe_scalars(port)
    assert set(tel) == set(jtel) and tel
    for key, value in collect_moe_metadata(port).items():
        np.testing.assert_allclose(value, float(jtel[key]), rtol=1e-5, atol=1e-5, err_msg=key)


def test_moe_params_convert_and_share_the_expert_layout(jobs):
    """The stacked experts keep their leading E axis through the
    conversion both ways, and ``param_spec``'s expert rule, the slide
    stage's rule (``dist/stagemesh.py``) and ``shard_state_dict(...,
    axis="expert")`` all split exactly that axis of exactly those
    tensors."""
    params, _, _, port, _ = jobs["encoder"].result()
    state = port.state_dict()
    back = flax_params_from_state_dict(state)
    for path in (("layers_1", "moe_layer", "experts", "fc1", "kernel"), ("layers_1", "moe_layer", "gate", "wg",
                                                                          "kernel")):
        node_a, node_b = back, params
        for p in path:
            node_a, node_b = node_a[p], node_b[p]
        np.testing.assert_array_equal(node_a, np.asarray(node_b))
    stage = stage_param_specs("slide_encoder", state)
    parts = [shard_state_dict(state, r, 2, axis="expert") for r in range(2)]
    experts = [n for n in state if ".experts." in n]
    assert experts
    for name, t in state.items():
        spec = param_spec(name, t, expert_axis="expert")
        if name in experts:
            assert spec == ("expert",) + (None,) * (t.dim() - 1), name
            assert stage[name][:1] == ("expert",) and not any(stage[name][1:]), name
            assert parts[0][name].shape[0] == t.shape[0] // 2
        else:
            assert "expert" not in spec and "expert" not in stage[name], name
            assert parts[0][name] is t


def _ranks(work: str):
    """Four ranks' expert-parallel results, and the JAX side: the
    unsharded layer and the ``shard_map`` choreography over four CPU
    devices, with their gradients (computed while the ranks run)."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=rb.MOE_X_SHAPE).astype(np.float32)
    S = rb.MOE_WORLD * rb.MOE_S_LOC
    E, M, F = rb.MOE_E, rb.MOE_M, rb.MOE_F
    inputs = {"x": x, "ct": rng.normal(size=x.shape).astype(np.float32),
              "tokens": rng.normal(size=(S, M)).astype(np.float32),
              "tokens_ct": rng.normal(size=(S, M)).astype(np.float32),
              "wg": (rng.normal(size=(M, E)) * 0.1).astype(np.float32),
              "w1": (rng.normal(size=(E, M, F)) * 0.1).astype(np.float32),
              "w2": (rng.normal(size=(E, F, M)) * 0.1).astype(np.float32)}
    jlayer = jax_moe_layer.MOELayer(**rb.MOE_LAYER)
    # seeded weights in the port's layout (no JAX init to compile first)
    port = MOELayer(**rb.MOE_LAYER)
    state = {k: torch.from_numpy((0.2 * rng.normal(size=tuple(v.shape))).astype(np.float32))
             for k, v in port.state_dict().items()}
    params = flax_params_from_state_dict(state)
    torch.save(state, f"{work}/moe_state.pt")
    np.savez(f"{work}/inputs.npz", **inputs)
    procs = rb.start_ranks(rb.moe_rank, rb.MOE_WORLD, work)
    try:
        w = rb.MOE_AUX_WEIGHT

        def layer_loss(p, x):
            out, l_aux = jlayer.apply({"params": p}, x)
            return (out * inputs["ct"]).sum() + w * l_aux, (out, l_aux)

        (_, (out, aux)), (gp, gx) = _jitted(jax.value_and_grad(layer_loss, argnums=(0, 1), has_aux=True),
                                            params, jnp.asarray(x))
        jax_side = {"gathered": (np.asarray(out), float(aux), np.asarray(gx), state_dict_from_flax_params(
            jax.device_get(gp)))}
        mesh = jax_make_mesh(rb.MOE_WORLD, axis_sizes={"expert": rb.MOE_WORLD})

        def a2a_loss(tokens, wg, w1, w2):
            def gate_fn(t):
                return jr.top1_gating(t @ wg)

            def expert_fn(p, d):
                a, b = p
                return jax.vmap(lambda a, b, d: jax.nn.gelu(d @ a) @ b)(a, b, d)

            out, l_aux = jax_moe_expert_parallel(mesh, gate_fn, expert_fn, (w1, w2), tokens)
            return (out * inputs["tokens_ct"]).sum() + w * l_aux, (out, l_aux)

        (_, (out, aux)), grads = _jitted(jax.value_and_grad(a2a_loss, argnums=(0, 1, 2, 3), has_aux=True),
                                        *(jnp.asarray(inputs[k]) for k in ("tokens", "wg", "w1", "w2")))
        jax_side["a2a"] = (np.asarray(out), float(aux), [np.asarray(g) for g in grads])
    finally:
        results = rb.join_ranks(procs, work)
    return jax_side, results


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The module's slow parts, started at once in threads: ``{name:
    future}``."""
    work = str(tmp_path_factory.mktemp("moe"))
    pool = ThreadPoolExecutor(max_workers=6)
    futures = {"dryrun": pool.submit(dryrun_multichip, 4, device="cpu"), "ranks": pool.submit(_ranks, work),
               "layers": pool.submit(_jax_layers), "encoder": pool.submit(_jax_encoder),
               "gating": pool.submit(_jax_gating), "xmoe": pool.submit(_jax_xmoe)}
    yield futures
    pool.shutdown(wait=True)


def test_expert_parallel_gathered_matches_jax_single_device(jobs):
    """Variant (a) over four ranks (8 experts, 2 a rank), every rank on the
    same tokens: each rank's output and ``l_aux`` equal JAX's unsharded
    layer's (1e-5), and the gradients of the input, the gate and the
    experts (gathered over the group) JAX's (1e-4)."""
    jax_side, results = jobs["ranks"].result()
    out, aux, gx, gp = jax_side["gathered"]
    for r in results:
        np.testing.assert_allclose(r["gathered_out"], out, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(r["gathered_l_aux"]), aux, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["gathered_dx"], gx, atol=1e-4, rtol=1e-4)
        for name, g in gp.items():
            np.testing.assert_allclose(r[f"gathered_grad_{name}"], g.numpy(), atol=1e-4, rtol=1e-4, err_msg=name)


def test_expert_parallel_gathered_dropout_matches_one_device(jobs):
    """Variant (a) in training mode with activation and output dropout:
    after the same seed, each rank's output and gradients equal the
    one-device layer's (every expert draws its own mask, not one mask a
    rank's slice of experts), and the dropout took effect."""
    _, results = jobs["ranks"].result()
    for r in results:
        np.testing.assert_allclose(r["dropout_gathered_out"], r["dropout_single_out"], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(r["dropout_gathered_dx"], r["dropout_single_dx"], atol=1e-6, rtol=1e-6)
        for key in r:
            if key.startswith("dropout_single_grad_"):
                name = key[len("dropout_single_grad_"):]
                np.testing.assert_allclose(r[f"dropout_gathered_grad_{name}"], r[key], atol=1e-6, rtol=1e-6,
                                           err_msg=name)
        assert not np.allclose(r["dropout_single_out"], r["dropout_none_out"], atol=1e-3)


def test_expert_parallel_all_to_all_matches_jax_shard_map(jobs):
    """Variant (b), JAX's ``shard_map`` test's function: per-shard gating,
    the all-to-all and back; each rank's output slice (1e-5), the averaged
    ``l_aux``, and the gradients of its tokens and experts and the summed
    gate gradient (1e-4)."""
    jax_side, results = jobs["ranks"].result()
    out, aux, (dtok, dwg, dw1, dw2) = jax_side["a2a"]
    el = rb.MOE_E // rb.MOE_WORLD
    for rank, r in enumerate(results):
        mine = slice(rank * rb.MOE_S_LOC, (rank + 1) * rb.MOE_S_LOC)
        np.testing.assert_allclose(r["a2a_out"], out[mine], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(r["a2a_l_aux"]), aux, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r["a2a_dtokens"], dtok[mine], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["a2a_dw1"], dw1[rank * el:(rank + 1) * el], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["a2a_dw2"], dw2[rank * el:(rank + 1) * el], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["a2a_dwg"], dwg, atol=1e-4, rtol=1e-4)


def test_dryrun_multichip_4_on_cpu(jobs):
    """The port's ``dryrun_multichip(4)``: ``{data 2, seq 2, model 1}``
    and ``{data 2, expert 2}``, one line a stage with a finite loss."""
    lines = jobs["dryrun"].result()
    assert len(lines) == 2
    assert "mesh={'data': 2, 'seq': 2, 'model': 1}" in lines[0]
    assert "mesh={'data': 2, 'expert': 2}" in lines[1] and "experts=4" in lines[1]
    for line in lines:
        assert np.isfinite(float(line.rsplit("loss=", 1)[1]))
