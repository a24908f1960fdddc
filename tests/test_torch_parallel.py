"""The port's parallel layer (``gigapath_tpu_torch/parallel/``) held against
the JAX package's on the CPU.

``factorize``, ``param_spec`` over every parameter of the flagship slide
encoder and the ViT-G tile encoder (both built on ``meta``, against JAX's
spec of the flax leaf each comes from, in the torch weight's axis order),
the loss, and one ``make_train_step`` step against JAX's on the same
weights and batch. The data-parallel step runs in two rank processes
(``tests/torch_rank_bodies.py``, gloo over a ``FileStore`` under the test's
temporary directory), each on half of the batch: its loss (rtol 1e-5) and
gradients (atol 2e-5) equal the one-process step's, as in the JAX
package's ``tests/test_parallel.py``. The same ranks check the mesh
helpers, a state dict laid out over a ``model`` dim, and a train step over
a ``seq`` dim (the step gathers the tokens).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread a test process)

import torch_rank_bodies as rb
from gigapath_tpu.models.classification_head import ClassificationHead as JaxHead
from gigapath_tpu.parallel import mesh as jax_mesh
from gigapath_tpu.parallel import sharding as jax_sharding
from gigapath_tpu.parallel import spmd as jax_spmd
from gigapath_tpu_torch.models.classification_head import ClassificationHead
from gigapath_tpu_torch.parallel import mesh as port_mesh
from gigapath_tpu_torch.parallel import sharding as port_sharding
from gigapath_tpu_torch.parallel import spmd as port_spmd
from gigapath_tpu_torch.utils.convert import flax_params_from_state_dict, state_dict_from_flax_params


@pytest.mark.parametrize("axes", [("data", "seq"), ("data", "seq", "model"), ("data", "seq", "model", "expert")])
def test_factorize_matches_jax(axes):
    for n in range(1, 17):
        assert port_mesh.factorize(n, axes) == jax_mesh.factorize(n, axes), n


def _jax_spec(name: str, tensor) -> tuple:
    """JAX's ``param_spec`` of the flax leaf a ``state_dict`` entry comes
    from (``utils/convert.py``'s renaming: ``layers.N`` -> ``layers_N``, a
    2-D or 4-D ``weight`` -> ``kernel`` in the flax axis order, a 1-D one ->
    ``scale``), permuted back to the torch weight's axis order."""
    shape = tuple(tensor.shape)
    parts = re.sub(r"\b(layers|blocks)\.(\d+)\b", r"\1_\2", name).split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel" if len(shape) in (2, 4) else "scale"
    perm = {2: (1, 0), 4: (2, 3, 1, 0)}.get(len(shape)) if parts[-1] == "kernel" else None
    flax_shape = tuple(shape[j] for j in perm) if perm else shape
    spec = tuple(jax_sharding.param_spec(parts, jax.ShapeDtypeStruct(flax_shape, jnp.float32)))
    if perm and spec:
        spec = tuple((spec + (None,) * len(shape))[j] for j in {2: (1, 0), 4: (3, 2, 0, 1)}[len(shape)])
    return spec


def _meta_state(which):
    from gigapath_tpu_torch.utils.registry import create_model_from_registry

    if which == "tile":
        import gigapath_tpu_torch.models.tile_encoder  # noqa: F401

        arch, kw = "gigapath_tile_enc", {}
    else:
        import gigapath_tpu_torch.models.slide_encoder  # noqa: F401

        arch, kw = "gigapath_slide_enc12l768d", {"in_chans": 1536}
    with torch.device("meta"):
        return create_model_from_registry(arch, **kw).state_dict()


@pytest.mark.parametrize("which", ["slide", "tile"])
def test_param_spec_matches_jax_transposed(which):
    """Every parameter of the flagship slide encoder and the ViT-G tile
    encoder, built on ``meta``: the port's spec over the torch tensor is
    JAX's over the flax leaf, permuted to the torch axis order."""
    state = _meta_state(which)
    got = {name: port_sharding.param_spec(name, t) for name, t in state.items()}
    assert got == {name: _jax_spec(name, t) for name, t in state.items()}
    assert sum(spec == ("model", None) for spec in got.values()) > 0  # column-parallel weights
    assert sum(spec == (None, "model") for spec in got.values()) > 0  # row-parallel weights
    # the model rule off: everything replicated, as the JAX rule degrades
    assert all(port_sharding.param_spec(n, t, model_axis=None) == () for n, t in state.items())


def test_param_spec_expert_axis_matches_jax():
    t = torch.empty(4, 8, 16, device="meta")
    leaf = jax.ShapeDtypeStruct((4, 8, 16), jnp.float32)
    want = tuple(jax_sharding.param_spec(["moe", "experts", "fc1", "kernel"], leaf, expert_axis="expert"))
    assert port_sharding.param_spec("moe.experts.fc1.weight", t, expert_axis="expert") == want


@pytest.mark.parametrize("task", ["multi_class", "multi_label"])
def test_cross_entropy_loss_matches_jax(task):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(5, 3)).astype(np.float32)
    if task == "multi_label":
        labels = rng.integers(0, 2, size=(5, 3)).astype(np.float32)
    else:
        labels = rng.integers(0, 3, size=5).astype(np.int32)
    ref = float(jax.jit(jax_spmd.cross_entropy_loss, static_argnums=2)(logits, labels, task))
    got = float(port_spmd.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), task))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_collect_moe_l_aux_is_zero_without_moe_layers():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2))
    assert float(port_spmd.collect_moe_l_aux(model)) == 0.0


def _batch():
    rng = np.random.default_rng(2)
    return {
        "images": rng.normal(size=(rb.DATA_B, rb.DATA_N, rb.DATA_HEAD["input_dim"])).astype(np.float32),
        "coords": rng.uniform(0, 25000, (rb.DATA_B, rb.DATA_N, 2)).astype(np.float32),
        "labels": np.array([0, 2], np.int64),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX head's weights and step, the port's one-process step from
    the same weights, and the two data-parallel ranks' results (run while
    JAX's step compiles)."""
    work = str(tmp_path_factory.mktemp("data_parallel"))
    jhead = JaxHead(**rb.DATA_HEAD, slide_kwargs=rb.DATA_SLIDE)
    batch = _batch()
    torch.manual_seed(0)
    rng = np.random.default_rng(1)  # non-trivial norms and biases
    state = {k: v + torch.from_numpy(0.05 * rng.normal(size=tuple(v.shape)).astype(np.float32))
             for k, v in ClassificationHead(**rb.DATA_HEAD, **rb.DATA_SLIDE).state_dict().items()}
    params = flax_params_from_state_dict(state)
    torch.save(state, f"{work}/head_state.pt")
    np.savez(f"{work}/batch.npz", **batch)
    procs = rb.start_ranks(rb.data_parallel_rank, rb.DATA_WORLD, work)
    try:
        opt = optax.sgd(rb.DATA_LR)
        step = jax.jit(jax_spmd.make_train_step(jhead, opt))
        jbatch = {k: jnp.asarray(v.astype(np.int32) if k == "labels" else v) for k, v in batch.items()}
        logits = jax.jit(jax_spmd.make_eval_step(jhead))(params, jbatch)
        new_params, _, jloss = step(params, opt.init(params), jbatch, jax.random.PRNGKey(1))
        jax_side = {"loss": float(jloss), "params": state_dict_from_flax_params(jax.device_get(new_params)),
                    "logits": np.asarray(logits)}

        model = ClassificationHead(**rb.DATA_HEAD, **rb.DATA_SLIDE)
        model.load_state_dict(state, strict=True)
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        logits = port_spmd.make_eval_step(model)(tbatch)
        port_step = port_spmd.make_train_step(model, torch.optim.SGD(model.parameters(), lr=rb.DATA_LR))
        loss = port_step(tbatch)
        single = {"loss": float(loss), "params": {k: v.clone() for k, v in model.state_dict().items()},
                  "logits": logits.numpy(),
                  "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
                  "state": state}
    finally:
        ranks = rb.join_ranks(procs, work)
    return jax_side, single, ranks


def test_train_step_matches_jax(runs):
    """One SGD step of the port's ``make_train_step`` against JAX's on the
    same weights and batch: the loss and every updated parameter."""
    jax_side, single, _ = runs
    np.testing.assert_allclose(single["loss"], jax_side["loss"], rtol=1e-5)
    assert set(single["params"]) == set(jax_side["params"])
    for name, value in single["params"].items():
        np.testing.assert_allclose(value.numpy(), jax_side["params"][name].numpy(), atol=1e-5, err_msg=name)


def test_eval_step_matches_jax(runs):
    jax_side, single, _ = runs
    np.testing.assert_allclose(single["logits"], jax_side["logits"], atol=1e-5, rtol=1e-5)


def test_data_parallel_step_matches_one_process(runs):
    """Two gloo ranks, each on half of the batch: the averaged loss and
    gradients equal the one-process step's over the whole batch."""
    _, single, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), single["loss"], rtol=1e-5)
        grads = {k[len("grad_"):]: v for k, v in r.items() if k.startswith("grad_")}
        assert set(grads) == set(single["grads"])
        for name, g in grads.items():
            np.testing.assert_allclose(g, single["grads"][name].numpy(), atol=2e-5, err_msg=name)


def test_mesh_helpers_on_ranks(runs):
    _, _, ranks = runs
    for r in ranks:
        assert r["data_mesh"].tolist() == [rb.DATA_WORLD, rb.DATA_WORLD, 1]
        assert [str(p) for p in r["shard_batch_seq"]] == ["Shard(dim=0)"]
        assert str(r["refusal_bad_size"]) == "ValueError"


def test_train_step_refuses_a_seq_dim(runs):
    """The train step no longer refuses a ``seq`` dim: each rank passes
    half of the tokens, the step gathers them at its entry, and its loss is
    the one-process step's (the tensor-parallel steps are held against JAX
    in ``tests/test_torch_tensor_parallel.py``)."""
    _, single, ranks = runs
    assert [str(r["refusal_seq_step"]) for r in ranks] == ["ok"] * rb.DATA_WORLD
    for r in ranks:
        np.testing.assert_allclose(float(r["seq_step_loss"]), single["loss"], rtol=1e-5)


@pytest.mark.parametrize("name,dim", [("slide_encoder.encoder.layers.0.ffn.fc1.weight", 0),
                                      ("slide_encoder.encoder.layers.0.self_attn.out_proj.weight", 1),
                                      ("slide_encoder.encoder.layers.0.ffn.fc1.bias", None)])
def test_apply_shardings_lays_out_over_model(runs, name, dim):
    """Over a ``model`` dim of two ranks a column-parallel weight is split
    by rows, a row-parallel one by columns, a bias replicated."""
    _, single, ranks = runs
    full = single["state"][name].numpy()
    for rank, r in enumerate(ranks):
        local = r[f"local_{name}"]
        if dim is None:
            np.testing.assert_array_equal(local, full)
        else:
            np.testing.assert_array_equal(local, np.split(full, rb.DATA_WORLD, axis=dim)[rank])
