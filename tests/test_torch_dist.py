"""Distribution on DTensor (``repro_torch.dist.sharding``, ``launch/mesh.py``)
against the reference's ``repro.dist.sharding``: the spec helpers on the
reference's own fake mesh, every arch's parameter specs and cache axes, the
batch and cache stand-ins of every cell, and, across CPU processes on gloo
(``tests/torch_dist_ranks.py``: each rank its own process under a time
limit, every rank's exit code and traceback reported), the sharded MoE
path, the SPMD train step, ``compressed_psum`` and
``ckpt.restore(shardings=)``.

The sharded MoE routes each data shard's tokens into a capacity buffer of
its own and averages the shards' load-balance losses, as the reference's
``shard_map`` path does (its documented deviation from global capacity).
So the mesh's results are held to the local path run on each data shard's
tokens (within 1e-5 f32, gradients included); against the local path over
the whole batch the loss differs by the per-shard capacity, bounded here by
the reference's own test's 5e-3.  Params after a step: within 1e-3 of each
leaf's largest (ROADMAP.md, tolerance notes).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as RefP  # noqa: E402

from repro.configs.registry import cells, get_config as ref_get_config, lm_archs  # noqa: E402
from repro.dist import sharding as ref_shd  # noqa: E402
from repro.launch import inputs as ref_inputs  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.params import init_params as ref_init_params  # noqa: E402
from repro.models.transformer import LM as RefLM  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import RunShape  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import inputs  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.bridge import params_from_numpy  # noqa: E402
from repro_torch.models.transformer import LM, cross_entropy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from torch_dist_ranks import (CHANNEL_MIX_SHAPES, DECODE_LEN_REC, DECODE_RING,  # noqa: E402
                              STATE_BLOCKS, STATE_S, mamba_local, paths_inputs, paths_local,
                              run_ranks, split_inputs, split_local, state_close, state_inputs,
                              state_local)

MOE_ARCH = "granite_moe_1b_a400m"
TOL = 1e-5
REF_LOSS_TOL = 1e-4
GRAD_TOL = 1e-3
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=10)
TRAIN_SHAPE = RunShape("t", 32, 4, "train")   # the reference's test_spmd_train_step_8_devices
RANK_TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several test processes at once; one torch thread per
    process keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeMesh:
    """The reference's tests/test_dist.py mesh stand-in."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _same(port_spec, ref_spec) -> bool:
    return type(port_spec) is shd.P and tuple(port_spec) == tuple(ref_spec)


# -- the spec helpers -------------------------------------------------------------

@pytest.mark.parametrize("spec, shape", [
    (("data", "model"), (32, 32)), (("data", "model"), (32, 8)),
    ((("data", "model"),), (256,)), ((("data", "model"),), (128,)),
    (("data",), (16, 4)), ((None, "model"), (3, 5)), (("pod",), (8,)),
])
def test_filter_spec_matches_reference(spec, shape):
    mesh = _FakeMesh({"data": 16, "model": 16})
    assert _same(shd.filter_spec(shd.P(*spec), shape, mesh),
                 ref_shd.filter_spec(RefP(*spec), shape, mesh))


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 4}])
@pytest.mark.parametrize("names", [("batch",), ("batch", "seq", "heads", None),
                                   ("batch", "kv_seq"), ("vocab", "mlp")])
def test_logical_spec_and_pod_expansion_match_reference(sizes, names):
    mesh = _FakeMesh(sizes)
    with shd.use_mesh(mesh), ref_shd.use_mesh(mesh):
        assert _same(shd.logical_spec(*names), ref_shd.logical_spec(*names))
    with shd.override_rules(kv_seq=("model", "data")), \
            ref_shd.override_rules(kv_seq=("model", "data")), shd.use_mesh(mesh), \
            ref_shd.use_mesh(mesh):
        assert _same(shd.logical_spec(*names), ref_shd.logical_spec(*names))
    assert shd.ACT_RULES["kv_seq"] == ref_shd.ACT_RULES["kv_seq"] == "model"


def test_constraint_is_the_identity_without_a_mesh_or_a_dtensor():
    x = torch.ones(4, 4)
    assert shd.get_mesh() is None
    assert shd.constraint(x, "batch", None) is x
    with shd.use_mesh(_FakeMesh({"data": 2, "model": 4})):
        assert shd.constraint(x, "batch", None) is x
    assert shd.get_mesh() is None


def test_rules_and_placements():
    assert shd.PARAM_RULES == ref_shd.PARAM_RULES and shd.ACT_RULES == ref_shd.ACT_RULES
    mesh = _FakeMesh({"pod": 2, "data": 2, "model": 4})
    from torch.distributed.tensor import Replicate, Shard
    assert shd.placements_for(shd.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements_for(shd.P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        shd.placements_for(shd.P(("model", "data")), mesh)
    with shd.override_param_rules(embed=None):
        assert shd.PARAM_RULES["embed"] is None
    assert shd.PARAM_RULES["embed"] == "data"


# -- spec trees, cache axes, stand-ins ----------------------------------------------------

def _spec_paths(tree, path=()):
    if isinstance(tree, dict):
        return {p: s for k in tree for p, s in _spec_paths(tree[k], path + (k,)).items()}
    return {path: tree}


@pytest.mark.parametrize("arch", lm_archs())
def test_param_specs_equal_the_reference(arch):
    rules = {"embed": None}
    for kw in ({}, {"rules": rules}):
        ours = _spec_paths(LM(get_config(arch), **kw).param_specs())
        ref = _spec_paths(RefLM(ref_get_config(arch), **kw).param_specs())
        assert ours.keys() == ref.keys()
        for path in ref:
            assert _same(ours[path], ref[path]), path


def _axes_tree(t):
    """A cache-axes tree with each state NamedTuple as (its name, fields)."""
    if isinstance(t, dict):
        return {k: _axes_tree(v) for k, v in t.items()}
    if hasattr(t, "_fields"):
        return type(t).__name__, tuple(_axes_tree(x) for x in t)
    if isinstance(t, tuple) and any(isinstance(x, tuple) for x in t):
        return tuple(_axes_tree(x) for x in t)
    return t


@pytest.mark.parametrize("arch", lm_archs())
def test_cache_spec_axes_equal_the_reference(arch):
    ours, ref = LM(get_config(arch)).cache_spec_axes(), RefLM(ref_get_config(arch)).cache_spec_axes()
    assert _axes_tree(ours) == _axes_tree(ref)


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch", lm_archs())
def test_input_specs_and_abstract_cache_equal_the_reference(arch):
    model, ref = LM(get_config(arch)), RefLM(ref_get_config(arch))
    for sname, ref_shape in cells(arch).items():
        shape = RunShape(*dataclasses.astuple(ref_shape))
        ours, theirs = inputs.input_specs(model.cfg, shape), ref_inputs.input_specs(ref.cfg, ref_shape)
        assert list(ours) == list(theirs)
        for k, v in ours.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == theirs[k].shape and _dtype_name(v.dtype) == str(theirs[k].dtype)
        ours, theirs = leaves(inputs.abstract_cache(model, shape)), jax.tree.leaves(
            ref_inputs.abstract_cache(ref, ref_shape))
        assert len(ours) == len(theirs), sname
        for o, t in zip(ours, theirs):
            if isinstance(o, int):      # the port's cache lengths are host ints
                assert t.shape == () and str(t.dtype) == "int32"
            else:
                assert o.device.type == "meta", sname
                assert tuple(o.shape) == t.shape and _dtype_name(o.dtype) == str(t.dtype), sname


def test_axes_to_shardings_of_a_cache():
    model = LM(get_config("zamba2_7b").smoke())
    cache = inputs.abstract_cache(model, RunShape("d", 64, 4, "decode"))
    mesh = _FakeMesh({"data": 2, "model": 4})
    with shd.use_mesh(mesh):
        sh = shd.axes_to_shardings(model.cache_spec_axes(), cache, mesh)
    assert sh["layers"]["attn"]["main"][0].spec == shd.P(None, "data", "model", None, None)
    assert sh["layers"]["attn"]["recent"][1].spec == shd.P(None, "data", None, None, None)
    assert sh["layers"]["mamba"].conv.spec == shd.P(None, "data", None, "model")
    assert sh["len"].spec == shd.P()


# -- the MoE layer on gloo ----------------------------------------------------------------

def _moe_inputs(seed=0, B=4, S=16):
    cfg = ref_get_config(MOE_ARCH).smoke()
    w = jax.tree.map(np.asarray, ref_init_params(jax.random.key(0), ref_moe.moe_defs(cfg)))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    gout = rng.normal(size=x.shape).astype(np.float32)
    return cfg, w, x, gout, 0.7


def _local_moe(w, x, gout, gaux, n_data):
    """The port's local path on each data shard's tokens: out, the shards'
    mean aux, and the gradients of x and every weight."""
    cfg = get_config(MOE_ARCH).smoke()
    ws = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in w.items()}
    xs = torch.from_numpy(x.copy()).requires_grad_()
    outs, auxs = zip(*(moe.apply_moe(ws, cfg, xb) for xb in xs.chunk(n_data)))
    out, aux = torch.cat(outs), sum(auxs) / n_data
    ((out * torch.from_numpy(gout)).sum() + gaux * aux).backward()
    return dict(out=out.detach(), aux=aux.detach(), x=xs.grad, **{k: v.grad for k, v in ws.items()})


def _run_moe(tmp_path, mesh_shape, w, x, gout, gaux):
    torch.save({**{k: torch.from_numpy(np.array(v)) for k, v in w.items()}, "x": torch.from_numpy(x),
                "gout": torch.from_numpy(gout), "gaux": torch.tensor(gaux)}, tmp_path / "inputs.pt")
    outs = run_ranks("moe", mesh_shape[0] * mesh_shape[1], tmp_path, RANK_TIMEOUT, arch=MOE_ARCH,
                     mesh=list(mesh_shape), axes=["data", "model"])
    for o in outs[1:]:   # every rank gathers the same whole tensors
        assert all(torch.equal(o[k], outs[0][k]) for k in ("out", "aux", "x", "wg"))
    return outs[0]


def test_moe_on_a_1x1_mesh_matches_local_and_reference(tmp_path):
    """The reference's ``test_moe_shard_map_matches_local`` on a (1, 1)
    gloo mesh, and the reference's local ``apply_moe`` on the same params."""
    cfg, w, x, gout, gaux = _moe_inputs(B=2)
    res = _run_moe(tmp_path, (1, 1), w, x, gout, gaux)
    local = _local_moe(w, x, gout, gaux, 1)
    for k in local:
        err = float((res[k] - local[k]).abs().max())
        assert err <= TOL * max(1.0, float(local[k].abs().max())), (k, err)
    ref_out, ref_aux = ref_moe.apply_moe({k: jnp.asarray(v) for k, v in w.items()}, cfg,
                                         jnp.asarray(x))
    assert np.abs(res["out"].numpy() - np.asarray(ref_out)).max() < TOL
    assert abs(float(res["aux"]) - float(ref_aux)) < TOL


def test_moe_on_a_2x4_mesh_matches_the_local_path_with_gradients(tmp_path):
    """8 ranks: the weights' d dim FSDP-gathered over "data" (its gradient a
    reduce-scatter), f sharded over "model" with the partial outputs summed;
    out, aux and every gradient against the local path on each data
    shard's tokens."""
    cfg, w, x, gout, gaux = _moe_inputs()
    res = _run_moe(tmp_path, (2, 4), w, x, gout, gaux)
    assert res["placements"]["wg"] == "(Shard(dim=1), Shard(dim=2))"
    local = _local_moe(w, x, gout, gaux, 2)
    for k in local:
        err = float((res[k] - local[k]).abs().max())
        assert err <= TOL * max(1.0, float(local[k].abs().max())), (k, err)


# -- the SPMD train step on gloo ----------------------------------------------------------

def _train_inputs(arch):
    cfg = ref_get_config(arch).smoke()
    ref = RefLM(cfg, attn_impl="chunked", remat="full")
    ref_params = ref.init(jax.random.key(0))
    model = LM(get_config(arch).smoke(), attn_impl="chunked", remat="full")
    params = params_from_numpy(model, jax.tree.map(np.asarray, ref_params), device="cpu")
    batch = inputs.make_batch(model.cfg, TRAIN_SHAPE, device="cpu")
    return ref, ref_params, model, params, batch


def _local_step(model, params, batch, n_data):
    """The no-mesh step on the mesh's semantics: the loss and gradients
    averaged over the data shards' batches (each its own MoE capacity),
    then one AdamW update.  Returns (losses per shard, gradients, params
    after)."""
    losses, grads = [], []
    for i in range(n_data):
        loss, g = value_and_grad(model.train_loss, params,
                                 {k: v.chunk(n_data)[i] for k, v in batch.items()})
        losses.append(float(loss))
        grads.append(g)
    mean = tree_map(lambda *gs: sum(gs) / n_data, *grads)
    new, _, _ = adamw.apply_updates(params, mean, adamw.init_opt_state(params),
                                    adamw.AdamWConfig(**OPT))
    return losses, mean, new


def _run_train(tmp_path, arch, mesh_shape, params, batch):
    torch.save({"params": params, "batch": batch}, tmp_path / "inputs.pt")
    outs = run_ranks("train", mesh_shape[0] * mesh_shape[1], tmp_path, RANK_TIMEOUT, arch=arch,
                     mesh=list(mesh_shape), axes=["data", "model"], attn="chunked",
                     remat="full", opt=OPT)
    assert all(o["metrics"] == outs[0]["metrics"] for o in outs)
    return outs[0]


def _step_close(res, grads, after):
    """Every gradient within 1e-3 of its leaf's largest.  The params after
    the step within 1e-3 of their leaf's largest wherever the gradient is
    resolved (at least 1e-3 of its leaf's largest); where it is not, its
    sign and size are f32 rounding of the sums, and AdamW's first step
    moves an element by about lr whatever its gradient's size: there
    within 2 lr (1 + weight decay)."""
    lr, wd = OPT["lr"], adamw.AdamWConfig().weight_decay
    for g_mesh, g, p_mesh, p in zip(leaves(res["grads"]), leaves(grads), leaves(res["params"]),
                                    leaves(after), strict=True):
        assert g_mesh.shape == g.shape and p_mesh.shape == p.shape
        g_max = max(float(g.abs().max()), 1e-3)
        assert float((g_mesh - g).abs().max()) <= GRAD_TOL * g_max
        resolved = g.abs() >= GRAD_TOL * g_max
        diff = (p_mesh - p).abs()
        assert float(diff[resolved].max()) <= GRAD_TOL * max(float(p.abs().max()), 1e-3)
        assert float(diff.max()) <= 2 * lr * (1 + wd)


def _work_split(res, cfg, mesh_shape):
    """The rank did its share of the work, not the whole batch's or all
    heads': each local attention call had H / "model" query heads (the
    smoke granite_moe_1b_a400m's 4 on 2 KV heads split by query heads,
    port fault F7), and no local logits, nor their gradient, held more
    rows than the rank's batch shard (port fault F6)."""
    assert res["q_heads"] == [cfg.n_heads // mesh_shape[1]], res["q_heads"]
    rows = TRAIN_SHAPE.global_batch // mesh_shape[0] * TRAIN_SHAPE.seq_len
    assert 0 < res["vocab_rows"] <= rows, (res["vocab_rows"], rows)


def test_spmd_train_step_on_a_2x4_mesh(tmp_path):
    """The reference's ``test_spmd_train_step_8_devices`` on 8 gloo ranks:
    the smoke granite_moe_1b_a400m, remat full, chunked attention, batch
    4 x 32 on a (2, 4) ("data", "model") mesh; the loss within 1e-5
    (relative) of the no-mesh loss on the data shards' batches and 1e-4 of
    the reference's, and within the reference test's 5e-3 of the no-mesh
    loss over the whole batch; the gradients and the params after the step against the
    no-mesh step's."""
    ref, ref_params, model, params, batch = _train_inputs(MOE_ARCH)
    res = _run_train(tmp_path, MOE_ARCH, (2, 4), params, batch)
    assert res["placements"]["tok"] == "(Shard(dim=1), Shard(dim=0))"
    _work_split(res, model.cfg, (2, 4))
    loss = res["metrics"]["loss"]
    shard_losses, grads, after = _local_step(model, params, batch, 2)
    local = float(np.mean(shard_losses))
    assert abs(loss - local) <= TOL * abs(local), (loss, local)
    ref_losses = [float(ref.train_loss(ref_params, {k: jnp.asarray(v.chunk(2)[i].numpy())
                                                    for k, v in batch.items()})) for i in range(2)]
    assert abs(loss - float(np.mean(ref_losses))) < REF_LOSS_TOL
    with torch.no_grad():
        whole = float(model.train_loss(params, batch))
    assert abs(loss - whole) < 5e-3
    _step_close(res, grads, after)


def test_spmd_train_step_of_a_dense_model_on_a_1x2_mesh(tmp_path):
    """The same step for the smoke stablelm_1_6b with "model" of 2, so the
    attention, MLP and norms run sharded over heads and d_ff: the loss
    within 1e-5 (relative) of the no-mesh loss and 1e-4 of the
    reference's; the gradients and the params after the step against the
    no-mesh step's."""
    ref, ref_params, model, params, batch = _train_inputs("stablelm_1_6b")
    res = _run_train(tmp_path, "stablelm_1_6b", (1, 2), params, batch)
    assert res["placements"]["head"] == "(Shard(dim=0), Shard(dim=1))"
    _work_split(res, model.cfg, (1, 2))
    loss = res["metrics"]["loss"]
    (local,), grads, after = _local_step(model, params, batch, 1)
    assert abs(loss - local) <= TOL * abs(local), (loss, local)
    ref_loss = float(ref.train_loss(ref_params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}))
    assert abs(loss - ref_loss) < REF_LOSS_TOL
    _step_close(res, grads, after)


# -- the repaired sharded paths on gloo ------------------------------------------------------

@pytest.fixture(scope="module")
def paths_2x4(tmp_path_factory):
    """``case_paths`` on a (2, 4) mesh and without one, on the same seeded
    inputs."""
    work = tmp_path_factory.mktemp("paths_2x4")
    inp = paths_inputs()
    torch.save(inp, work / "inputs.pt")
    outs = run_ranks("paths", 8, work, RANK_TIMEOUT, mesh=[2, 4], axes=["data", "model"])
    return inp, outs, paths_local(inp)


def _close(mine, want, what):
    for k, v in want.items():
        err = float((mine[k] - v).abs().max())
        assert err <= TOL * max(1.0, float(v.abs().max())), (what, k, err)


@pytest.mark.parametrize("form", ["tied/all", "tied/mask", "untied/all", "untied/mask"])
def test_vocab_parallel_loss_on_a_2x4_mesh(paths_2x4, form):
    """Port fault F6's repair: the loss with the head product inside it,
    the vocab over "model" (4 slices of 512), the batch over "data", against
    the no-mesh ``cross_entropy`` over the same logits and its gradients
    (x's and the head's, or the tied table's), with the mask and without;
    the targets fall in every vocab slice."""
    inp, outs, _ = paths_2x4
    tied, masked = form.startswith("tied"), form.endswith("mask")
    assert set((inp["targets"] // 512).flatten().tolist()) == {0, 1, 2, 3}
    x = inp["x"].clone().requires_grad_()
    w = inp["tok" if tied else "head"].clone().requires_grad_()
    logits = x @ w.T if tied else x @ w
    loss = cross_entropy(logits, inp["targets"], inp["mask"] if masked else None)
    loss.backward()
    want = {"loss": loss.detach(), "x": x.grad, "w": w.grad}
    for o in outs:
        _close(o[f"loss/{form}"], want, form)


@pytest.mark.parametrize("form", ["tok", "head"])
def test_vocab_parallel_loss_function_is_bit_equal_to_its_ops(paths_2x4, form):
    """Port fault P2's repair: the loss after the head product is one
    autograd function; its forward runs the ops the local function ran
    under autograd before, in the same order, so the loss on the (2, 4)
    mesh is bit-equal to theirs (``torch_dist_ranks._nll_before``), tied
    (the table) and untied (the head)."""
    _, outs, _ = paths_2x4
    for o in outs:
        assert o["loss_checks"][f"bit_equal/{form}"]


def test_vocab_parallel_loss_saves_no_f32_logits(paths_2x4):
    """Port fault P2: in bfloat16, what autograd keeps for the loss's
    backward on the (2, 4) mesh holds no float32 tensor as wide as the
    vocab or a rank's slice of it (512 of 2048): the function saves the
    bfloat16 logits, the f32 LSE (rows only) and the target's index and
    mask.  Before, the f32 copy of the logits and the gather's were."""
    _, outs, _ = paths_2x4
    for o in outs:
        saved = o["loss_checks"]["saved"]
        assert ("torch.bfloat16", (2, 32, 512)) in saved, saved
        wide = [(d, s) for d, s in saved if d == "torch.float32" and s and s[-1] in (512, 2048)]
        assert not wide, wide


@pytest.mark.parametrize("impl", ["chunked", "naive"])
def test_query_head_attention_on_a_2x4_mesh(paths_2x4, impl):
    """Port fault F7's repair: 4 query heads on 2 KV heads, "model" 4, so
    each rank runs its one query head against the one KV head it reads;
    out and the gradients of q, k and v against the no-mesh attention."""
    _, outs, local = paths_2x4
    for o in outs:
        assert o["q_heads"] == [1]
        _close(o[f"attention/{impl}"], local[f"attention/{impl}"], impl)


def test_vocab_parallel_lookup_on_a_2x4_mesh(paths_2x4):
    """Port fault F8's repair: each rank looks up the tokens of its vocab
    slice, the slices' rows summed over "model"; out and the table's
    gradient against the no-mesh lookup, the tokens in every slice."""
    inp, outs, local = paths_2x4
    assert set((inp["tokens"] // 512).flatten().tolist()) == {0, 1, 2, 3}
    for o in outs:
        assert torch.equal(o["lookup"]["out"], local["lookup"]["out"])
        _close(o["lookup"], local["lookup"], "lookup")


@pytest.fixture(scope="module")
def split_2x4(tmp_path_factory):
    """``case_split`` (the paths repaired for port faults F9-F11) on a (2, 4)
    mesh and without one, on the same seeded inputs."""
    work = tmp_path_factory.mktemp("split_2x4")
    inp = split_inputs()
    torch.save(inp, work / "inputs.pt")
    outs = run_ranks("split", 8, work, RANK_TIMEOUT, mesh=[2, 4], axes=["data", "model"])
    return inp, outs, split_local(inp)


@pytest.mark.parametrize("shape", list(CHANNEL_MIX_SHAPES))
def test_channel_mix_receptance_on_a_2x4_mesh(split_2x4, shape):
    """Port fault F9's repair: the smoke rwkv6_7b's channel mix, whose
    receptance ``wr`` has "embed_tp" columns that no axis splits: each rank
    computes its 32 of the 128 columns and they are gathered after the
    sigmoid.  Out and the gradients of x and every param against the
    no-mesh path, for a sequence (the weight slice gathered over "data"),
    a decode step (x's d split over "data", the partial products
    reduce-scattered onto the batch) and a step of one sequence (summed
    over "data")."""
    _, outs, local = split_2x4
    for o in outs:
        assert o["receptance_columns"] == [(128, 32)]
        _close(o[f"channel_mix/{shape}"], local[f"channel_mix/{shape}"], shape)


def test_mamba_projections_on_a_2x4_mesh(tmp_path):
    """Port fault F12's repair: a decode step of the smoke zamba2_7b's
    Mamba2 block, whose B and C projections ("state" columns, no axis) and
    dt projection each rank computes a quarter of (4 of B's and C's 16
    columns, 4 of dt's 16 heads).  Out and the new state against the
    no-mesh step."""
    inp = split_inputs()
    torch.save(inp, tmp_path / "inputs.pt")
    outs = run_ranks("mamba", 8, tmp_path, RANK_TIMEOUT, mesh=[2, 4], axes=["data", "model"])
    local = mamba_local(inp)
    for o in outs:
        assert o["mamba_columns"] == [(16, 4)]
        _close(o["mamba/step"], local["mamba/step"], "mamba")


STATE_MESHES = {"2x4": [2, 4], "1x4": [1, 4]}


@pytest.fixture(scope="module", params=list(STATE_MESHES))
def state_on_mesh(request, tmp_path_factory):
    """``case_state`` (port fault F14's repair) on a mesh and without one, on
    the same seeded inputs."""
    work = tmp_path_factory.mktemp(f"state_{request.param}")
    inp = state_inputs()
    torch.save(inp, work / "inputs.pt")
    mesh = STATE_MESHES[request.param]
    outs = run_ranks("state", mesh[0] * mesh[1], work, RANK_TIMEOUT, mesh=mesh,
                     axes=["data", "model"])
    return mesh, outs, state_local(inp)


@pytest.mark.parametrize("block", STATE_BLOCKS)
def test_state_path_on_a_mesh(state_on_mesh, block):
    """Port fault F14's repair: the smoke zamba2_7b's Mamba2 block and
    rwkv6_7b's time mix over a ragged sequence (40 tokens: the chunked form
    pads its last chunk) from a state, with the gradients of x, the state
    and every param (the bonus u's summed over the batch's ranks), then a
    decode step from the state it left, against the no-mesh path: each
    output within 1e-5 of max(1, its largest) of the no-mesh path run in
    float64, beyond the float32 no-mesh path's own distance from that run
    (``state_close``: float32 rounding puts two of the time mix's gradients
    1.4-1.6e-5 of their largest from it, with or without a mesh).  The
    decay math (the chunked form and the step) runs inside ``shard_map`` on
    plain tensors of the rank's rows and heads: no DTensor op of the decay,
    which PyTorch 2.11's DTensor could not run.  Mamba2's 16 heads divide
    "model" (4): each call holds 4; the time mix's 2 heads (of 64) do not:
    each call holds both, the batch alone split."""
    mesh, outs, local = state_on_mesh
    assert STATE_S % 32
    module, heads = {"mamba": ("mamba2", 16 // mesh[1]), "time_mix": ("rwkv6", 2)}[block]
    for o in outs:
        calls = [c for c in o["decay_calls"] if c[0] == module]
        assert calls == [(module, "chunked_decay_attention", False, heads),
                         (module, "decay_attention_step", False, heads)], o["decay_calls"]
        mine = {k: v for k, v in o.items() if k.startswith(f"{block}/")}
        state_close(mine, {r: {k: v for k, v in local[r].items() if k in mine} for r in local},
                    TOL)


def test_ring_segment_on_a_2x4_mesh(split_2x4):
    """Port fault F10's repair: the recent ring's segment (16 positions, 6
    of them filled), each "model" rank attending to its 4, the slices'
    partial attentions merged over the axis; out, lse and the gradients of
    q, k and v against the whole ring's ``_attention_with_lse``."""
    _, outs, local = split_2x4
    assert 4 < DECODE_LEN_REC + 1 <= DECODE_RING // 2   # ranks 2 and 3 attend to no token
    for o in outs:
        assert o["ring_positions"] == [DECODE_RING // 4]
        _close(o["ring"], local["ring"], "ring")


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "qwen2_vl_72b"])
def test_split_cache_decode_step_on_a_2x4_mesh(split_2x4, arch):
    """Port faults F10 and F11 on a decode step over the split cache (32
    tokens in the main store, 5 in the ring): smoke stablelm_1_6b's logits
    and the ring the step wrote, K and V of every layer, and smoke
    qwen2_vl_72b's first attention layer on the token embeddings, its
    output and the ring it wrote, against the no-mesh step (through all of
    qwen2_vl's layers the no-mesh step's own f32 rounding is 8e-5 from a
    float64 step, the mesh's 4e-5 from the no-mesh one).  Every attention
    projection's columns are split over "model": qwen2_vl_72b's 2 KV heads
    of 32 do not divide it, so a rank projects 16 of their 64 columns, half
    a head (F11), and the slices are gathered into the ring's whole heads;
    the ring positions each rank attends to are its 4 of 16 (F10)."""
    _, outs, local = split_2x4
    for o in outs:
        assert (64, 16) in o["projection_columns"]
        assert all(n == 4 * mine for n, mine in o["projection_columns"])
        assert o["ring_positions"] == [DECODE_RING // 4]
        _close(o[f"decode/{arch}"], local[f"decode/{arch}"], arch)


# -- compressed_psum and restore(shardings=) ------------------------------------------------

def test_compressed_psum_on_one_rank(tmp_path):
    """The reference's ``test_compressed_psum_on_one_device_mesh``."""
    res = run_ranks("psum", 1, tmp_path, RANK_TIMEOUT, mesh=[1], axes=["data"])[0]
    x = res["x"]
    assert float((res["out"] - x).abs().max()) < float(x.abs().max()) / 100


def test_compressed_psum_on_four_ranks_equals_its_formula(tmp_path):
    """int8 payloads summed in int32, scales and count summed, dequantised by
    the average scale: exact in f32 against numpy over the ranks' inputs."""
    outs = run_ranks("psum", 4, tmp_path, RANK_TIMEOUT, mesh=[4], axes=["data"])
    xs = [o["x"].numpy() for o in outs]
    scales = [np.float32(np.abs(x).max()) / np.float32(127.0) + np.float32(1e-12) for x in xs]
    qs = [np.clip(np.round(x / s), -127, 127).astype(np.int8) for x, s in zip(xs, scales)]
    want = sum(q.astype(np.int32) for q in qs).astype(np.float32) * (
        np.float32(sum(scales)) / np.float32(4.0))
    for o in outs:
        assert np.array_equal(o["out"].numpy(), want)


def test_restore_with_shardings_on_two_ranks(tmp_path):
    tree = {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6),
            "b": torch.arange(6, dtype=torch.float32) * 0.5,
            "e": torch.arange(8, dtype=torch.bfloat16).reshape(2, 4)}
    ckpt.save(str(tmp_path / "ck"), 0, tree)
    torch.save(tree, tmp_path / "inputs.pt")
    specs = {"w": ["data", None], "b": [None], "e": [None, "data"]}
    outs = run_ranks("restore", 2, tmp_path, RANK_TIMEOUT, mesh=[2], axes=["data"],
                     ckpt=str(tmp_path / "ck"), specs=specs)
    for o in outs:
        for k, t in tree.items():
            assert torch.equal(o[k]["full"], t) and o[k]["full"].dtype == t.dtype
        assert o["w"]["placements"] == "(Shard(dim=0),)" and o["w"]["local_shape"] == (2, 6)
        assert o["b"]["placements"] == "(Replicate(),)" and o["b"]["local_shape"] == (6,)
        assert o["e"]["local_shape"] == (2, 2)


def test_trainer_under_a_mesh_checkpoints_and_resumes(tmp_path):
    """``Trainer(mesh=)`` on a (1, 2) mesh, the path ``launch.train --full``
    takes under ``torchrun``: 3 steps of the smoke stablelm_1_6b with
    DTensor params, moments and batches, checkpointed by rank 0 from the
    gathered leaves, then resumed through ``restore(shardings=)`` for a 4th;
    the first loss within 1e-5 (relative) of the same trainer's without a
    mesh, the later ones within 1e-2 (AdamW moves each element by about lr
    whatever its gradient's size, so the rounding of near-zero gradients
    parts the runs: ROADMAP.md, tolerance notes, and chip_smoke.py's
    SMALL_TRAIN_TOL for the card against the CPU)."""
    args = dict(arch="stablelm_1_6b", seq=16, batch=2, steps=3, opt=OPT)
    res = run_ranks("trainer", 2, tmp_path, RANK_TIMEOUT, mesh=[1, 2], axes=["data", "model"],
                    **args)[0]
    cfg = get_config("stablelm_1_6b").smoke()
    model = LM(cfg, attn_impl="chunked", remat="full")
    out = Trainer(model, DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_per_shard=2),
                  adamw.AdamWConfig(**OPT),
                  TrainerConfig(total_steps=4, ckpt_every=100, ckpt_dir=str(tmp_path / "local"),
                                log_every=1000), device="cpu", log=lambda line: None).run()
    local = [m["loss"] for _, m in out["history"]]
    first, resumed = res["runs"]
    assert [s for s, _ in first] == [0, 1, 2] and [s for s, _ in resumed] == [3]
    rel = [abs(loss - want) / abs(want) for (_, loss), want in zip(first + resumed, local,
                                                                    strict=True)]
    assert rel[0] <= TOL and max(rel[1:]) <= 1e-2, rel
    assert res["placement"] == "(Shard(dim=1), Shard(dim=0))"


def test_moe_refuses_gradients_where_a_mesh_axis_duplicates_the_work():
    """A batch of 1 on a "data" axis of 2 leaves the tokens whole on both
    data ranks while the FSDP gather makes the weights whole too: their
    gradients would be summed twice, so the sharded path refuses to train
    there (it still runs without gradients)."""
    cfg = get_config(MOE_ARCH).smoke()
    p = {k: v[0] for k, v in LM(cfg).init(0, device="cpu")["layers"]["moe"].items()}
    with shd.use_mesh(_FakeMesh({"data": 2, "model": 4})):
        with pytest.raises(ValueError, match="split neither"):
            moe.apply_moe(p, cfg, torch.zeros(1, 8, cfg.d_model))
