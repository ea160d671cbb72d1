"""The port's sharding rules, meshes and row window on the CPU.

The rule tables against ``repro.dist.sharding`` on the same paths, and on
every leaf of the reference's parameter trees carried to the port's layout
(``convert``): a port leaf's spec is the reference leaf's spec without its
stacked layer axis (which the reference's rules split over "data" for a
stack of 1-D leaves; the port's layers are separate tensors), its last two
entries swapped for a torch-layout weight.  Also: the divisibility fallback, ``annotate`` / ``unshard_fsdp``
as identity without a mesh, the meshes (``make_production_mesh`` raising
without 256 ranks, a world of one in this process), ``put_batch``'s rows,
and the row window: bit for bit the single-device path outside a window
and in a world of one, the noise of a window's rows the global draw's rows
(the emu kernel's plain version by its ``row_base`` too), ``prng`` mode
raising inside one."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models.mlp import MLPClassifier as JMLP  # noqa: E402
from repro_torch import api, convert  # noqa: E402
from repro_torch.core import photonics as tph  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.hardware import channel  # noqa: E402
from repro_torch.kernels import emu_matmul as em  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import total_noise  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

P = jax.sharding.PartitionSpec


class _JaxMesh:
    """The reference's rule helpers read ``mesh.shape`` as a dict."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


class _Mesh:
    """A mesh's layout without a process group: axis names, sizes and this
    rank's coordinate on each."""

    def __init__(self, coords=None, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._coords = coords or {}

    def get_local_rank(self, name):
        return self._coords.get(name, 0)


PATHS = ["blocks/attn/q/w", "blocks/ffn/gate/w", "blocks/ffn/experts/gate/w",
         "embed/tok/table", "blocks/norm1/scale", "blocks/attn/q/b", "enc/ln/scale",
         "dec/ln1/scale", "head/ln_enc/bias", "head/out/w", "h0/w", "h1/b",
         "blocks/attn/q_norm_scale", "blocks/mixer/A_log", "grp_rec1/rglru/lambda"]


@pytest.mark.parametrize("path", PATHS)
def test_spec_for_path_is_the_references(path):
    spec, pat = tsh.spec_for_path(path)
    jspec, jpat = jsh.spec_for_path(path)
    assert tuple(spec) == tuple(jspec) and pat == jpat


def test_rule_tables_are_the_references():
    for rules, jrules in ((tsh.PARAM_RULES, jsh.PARAM_RULES),
                          (tsh.FEEDBACK_RULES, jsh.FEEDBACK_RULES)):
        assert [(p, tuple(s)) for p, s in rules] == [(p, tuple(s)) for p, s in jrules]
    assert set(tsh.ACT_RULES) == set(jsh.ACT_RULES)
    assert (tsh.MODEL, tsh.FSDP, tsh.POD) == (jsh.MODEL, jsh.FSDP, jsh.POD)


@pytest.mark.parametrize("name,ref", [
    ("blocks.3.attn.q.weight", "blocks/attn/q/w"), ("h0.bias", "h0/b"),
    ("embed.tok.table", "embed/tok/table"), ("params/blocks.0.ln1.scale", "params/blocks/ln1/scale"),
    ("blocks/attn/q/w", "blocks/attn/q/w")])
def test_port_names_read_as_reference_paths(name, ref):
    assert tsh.ref_path(name) == ref


@pytest.mark.parametrize("spec,ndim", [(P("model", "data"), 3), (P("model"), 0),
                                       (P("data", "model"), 1), (P(), 2)])
def test_fit_spec_is_the_references(spec, ndim):
    assert tuple(tsh._fit_spec(tsh.P(*spec), ndim)) == tuple(jsh._fit_spec(spec, ndim))


def _reference_shapes(arch):
    if arch == "mnist_mlp":
        jm = JMLP(in_dim=64, hidden=(32, 32))
    else:
        jm = jconfigs.get(arch).make_smoke()
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ["mnist_mlp", "qwen3-1.7b", "qwen2-moe-a2.7b",
                                  "minicpm3-4b", "whisper-small", "recurrentgemma-9b",
                                  "mamba2-130m"])
@pytest.mark.parametrize("sizes", [dict(data=2, model=2), dict(data=4, model=16)])
def test_every_leaf_splits_as_the_reference(arch, sizes):
    """Each port leaf's spec = its reference leaf's, without the stacked
    layer axis, a weight's last two entries swapped; divisibility included."""
    shapes = _reference_shapes(arch)
    port_shapes = convert.torch_shapes(shapes)
    layout = convert.layout_map(shapes)
    jmesh, mesh = _JaxMesh(**sizes), _Mesh(**sizes)
    seen = 0
    for path, leaf in convert._walk(shapes):
        ref = jsh._divisible(jsh._fit_spec(jsh.spec_for_path("/".join(path))[0], leaf.ndim),
                             leaf.shape, jmesh)
        count = leaf.shape[0] if path[0] in convert._STACKED else 1
        for _ in range(count):
            name, _leaf, layer, transpose = next(layout)
            # (the reference's rule may put "data" on a stacked 1-D leaf's
            # layer axis, a bias stack's: the port keeps each layer a tensor
            # of its own and splits it along its own dims only)
            expect = tuple(ref)[1:] if layer is not None else tuple(ref)
            if transpose and len(expect) >= 2:
                expect = expect[:-2] + (expect[-1], expect[-2])
            got = tsh.leaf_spec(name, port_shapes[name], mesh)
            assert tuple(got) == expect, (name, got, expect)
            seen += 1
    assert seen == len(port_shapes)


def test_feedback_splits_as_the_reference():
    fb = {"blocks": (4, 64, 128), "embed": (64, 128)}
    mesh, jmesh = _Mesh(data=2, model=2), _JaxMesh(data=2, model=2)
    for name, shape in fb.items():
        got = tsh.leaf_spec(name, shape, mesh, tsh.FEEDBACK_RULES)
        ref = jsh._divisible(jsh._fit_spec(jsh.spec_for_path(name, jsh.FEEDBACK_RULES)[0],
                                           len(shape)), shape, jmesh)
        assert tuple(got) == tuple(ref)


def test_divisibility_fallback():
    """Odd vocab (73448) is not split 16 ways; an axis the mesh lacks
    drops out, as in the reference."""
    mesh, jmesh = _Mesh(data=2, model=16), _JaxMesh(data=2, model=16)
    got = tsh.leaf_spec("embed.tok.table", (73448, 64), mesh)
    ref = jsh._divisible(jsh._fit_spec(jsh.spec_for_path("embed/tok/table")[0], 2),
                         (73448, 64), jmesh)
    assert tuple(got) == tuple(ref) == (None, "data")
    assert tuple(tsh._divisible(tsh.P(("pod", "data"), "model"), (8, 32), mesh)) == \
        tuple(jsh._divisible(P(("pod", "data"), "model"), (8, 32), jmesh)) == (None, "model")


def test_placements_and_shardings():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Mesh(data=2, model=4)
    assert tsh.placements(tsh.P("data", "model"), mesh) == (Shard(0), Shard(1))
    assert tsh.placements(tsh.P(None, "data"), mesh) == (Shard(1), Replicate())
    assert tsh.placements(tsh.P(), mesh) == (Replicate(), Replicate())
    pod = _Mesh(pod=2, data=2, model=2)
    assert tsh.placements(tsh.P(("pod", "data"), None), pod) == (Shard(0), Shard(0),
                                                                  Replicate())
    tree = {"params": {"blocks.0.attn.q.weight": torch.zeros(8, 16), "h0.bias": torch.zeros(8)},
            "step": 3}
    sh = tsh.make_param_shardings(mesh, tree)
    assert sh["params"]["blocks.0.attn.q.weight"].spec == ("model", "data")
    assert sh["params"]["blocks.0.attn.q.weight"].placements == (Shard(1), Shard(0))
    assert sh["params"]["h0.bias"].placements == (Replicate(), Shard(0))
    assert sh["step"].placements == (Replicate(), Replicate())
    batch = tsh.make_batch_shardings(mesh, {"x": torch.zeros(6, 3), "y": torch.zeros(5)})
    assert batch["x"].placements == (Shard(0), Replicate())
    assert batch["y"].placements == (Replicate(), Replicate())
    assert tsh.replicated(mesh).placements == (Replicate(), Replicate())
    assert tsh.batch_axes(pod) == jsh.batch_axes(_JaxMesh(pod=2, data=2, model=2))


def test_annotate_and_unshard_are_identity_without_a_mesh():
    x = torch.zeros(4, 4, 4)
    assert tsh.annotate(x, "act_btd") is x
    tree = {"blocks.0.attn.q.weight": torch.zeros(8, 8)}
    assert tsh.unshard_fsdp(tree) is tree
    with tsh.use_mesh(_Mesh(data=2, model=1)) as m:
        assert tsh.current_mesh() is m
        assert tsh.annotate(x, "act_btd") is x  # a plain tensor is not redistributed
        assert tsh.annotate(x, "no_such_rule") is x
    assert tsh.current_mesh() is None


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_ranks(multi_pod, n):
    with pytest.raises(RuntimeError, match=f"needs {n} devices, found 1"):
        tmesh.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        tmesh.make_host_mesh(4)


def test_importing_the_mesh_module_starts_no_group():
    import torch.distributed as dist

    assert not dist.is_initialized() and tmesh.world_size() == 1


@pytest.mark.parametrize("world,mb", [(4, 1), (4, 2), (2, 4)])
def test_put_batch_gives_each_rank_its_share_of_every_microbatch(world, mb):
    n = 16
    batch = {"x": np.arange(n * 3, dtype=np.float32).reshape(n, 3), "y": np.arange(n)}
    got = []
    for r in range(world):
        out = tsh.put_batch(_Mesh({"data": r}, data=world, model=1), batch, "cpu", mb)
        per = n // (world * mb)
        assert tuple(out.rows) == (r * per, per, n // mb)
        expect = np.concatenate([np.arange(i * n // mb + r * per, i * n // mb + (r + 1) * per)
                                 for i in range(mb)])
        np.testing.assert_array_equal(out["y"].numpy(), expect)
        assert out["y"].dtype == torch.int64
        got.append(out["y"].numpy())
    assert sorted(np.concatenate(got).tolist()) == list(range(n))


def test_put_batch_replicates_what_does_not_split():
    batch = {"x": np.zeros((10, 3), np.float32), "y": np.arange(10)}
    out = tsh.put_batch(_Mesh({"data": 1}, data=4, model=1), batch, "cpu")
    assert out.rows is None and out["y"].tolist() == list(range(10))
    mixed = {"x": np.zeros((8, 3), np.float32), "y": np.arange(4)}
    assert tsh.put_batch(_Mesh({"data": 1}, data=4, model=1), mixed, "cpu").rows is None


# ---------------------------------------------------------------------------
# the row window
# ---------------------------------------------------------------------------

def _operands(t=12, k=40, m=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(t, k, generator=g), torch.randn(m, k, generator=g)


BACKENDS = [("ref", "offchip_bpd"), ("cuda", "offchip_bpd"), ("emu", "emu_offchip")]


def _project(backend, preset, a, b, key=5, **kw):
    cfg = tph.PRESETS[preset]
    if backend == "emu":
        return channel.emulated_matmul(a, b, cfg, key=key, **kw)
    return tph.get_backend(backend).matmul(a, b, cfg, key=key)


@pytest.mark.parametrize("backend,preset", BACKENDS)
def test_a_world_of_one_is_the_single_device_path(backend, preset):
    a, b = _operands()
    plain = _project(backend, preset, a, b)
    with tph.row_window(tph.RowWindow(0, 4, 4)):
        windowed = _project(backend, preset, a, b)
    assert torch.equal(plain, windowed)
    with tph.row_window(None):
        assert tph.active_window() is None
        assert torch.equal(_project(backend, preset, a, b), plain)


@pytest.mark.parametrize("start,count,total", [(2, 2, 6), (0, 3, 6), (5, 1, 6)])
def test_window_noise_is_the_global_draws_rows(start, count, total):
    per = 4
    cfg = tph.PRESETS["offchip_bpd"]
    full = total_noise(9, (total * per, 24), 40, cfg, "cpu")
    with tph.row_window(tph.RowWindow(start, count, total)):
        part = total_noise(9, (count * per, 24), 40, cfg, "cpu")
        assert tph.global_rows(count * per) == (start * per, total * per)
    with pytest.raises(ValueError, match="whole examples"):
        tph.RowWindow(0, 2, 4).rows(5)
    assert torch.equal(part, full[start * per:(start + count) * per])


@pytest.mark.parametrize("backend,preset", BACKENDS)
def test_a_window_rank_gives_its_rows_of_the_global_product(backend, preset):
    """Rows [4, 8) of a 12-row batch under a window whose s_a is the global
    one (the rank's rows hold the global max) = those rows of the one-pass
    product: the same scale, the same noise."""
    a, b = _operands()
    a[5, 3] = 100.0  # the global max lies in the window's rows
    full = _project(backend, preset, a, b)
    with tph.row_window(tph.RowWindow(1, 1, 3)):
        part = _project(backend, preset, a[4:8], b)
    # (the CPU's matrix product may sum rows of a 4-row and a 12-row operand
    # in other orders; the noise is O(0.1))
    torch.testing.assert_close(part, full[4:8], rtol=1e-6, atol=1e-5)


def test_window_takes_one_max_per_operand_and_refuses_stacks():
    calls = []

    class Group:
        pass

    window = tph.RowWindow(0, 2, 2, Group())
    import torch.distributed as dist

    orig = dist.all_reduce
    dist.all_reduce = lambda t, op=None, group=None: calls.append((op, group))
    try:
        a = torch.randn(4, 8)
        assert torch.equal(window.amax(a), a.abs().amax())
        window.amax(a.reshape(4, 8))  # the same operand, another view object
        assert len(calls) == 1 and calls[0][0] == dist.ReduceOp.MAX
    finally:
        dist.all_reduce = orig
    with tph.row_window(tph.RowWindow(0, 2, 2)):
        with pytest.raises(ValueError, match="stacked"):
            tph.normalise_operands(torch.randn(3, 4, 8), torch.randn(3, 5, 8),
                                   tph.PRESETS["offchip_bpd"])
        with pytest.raises(ValueError, match="prng"):
            ops.photonic_matmul(torch.randn(4, 8), torch.randn(5, 8),
                                tph.PRESETS["offchip_bpd"], key=1, noise_mode="prng")


def _emu_case(t, m, k, preset="emu_onchip", n_buses=1, seed=0):
    cfg = dataclasses.replace(tph.PRESETS[preset], n_buses=n_buses)
    a, b = _operands(t, k, m, seed)
    a_n, b_n, _, _ = tph.normalise_operands(a, b, cfg)
    a_t, b_t, n_panels = channel.tile_operands(a_n, b_n, cfg)
    delta = channel.effective_deltas(b_t, cfg).contiguous()
    device = cfg.mrr
    kw = dict(n_panels=n_panels, gamma=float(device.gamma),
              sigma=float(channel._per_pass_sigma(cfg)), shot=float(device.shot_noise),
              adc_bits=device.adc_bits, amax=float(cfg.bank_cols), seed=em.seed_words(77))
    return a_t, delta, channel.alive_dead_ring_mask(cfg, "cpu"), kw


@pytest.mark.parametrize("t,m,k,n_buses", [(10, 24, 40, 1), (7, 60, 100, 3)])
@pytest.mark.parametrize("r,n", [(0, 4), (3, 4), (6, 1)])
def test_emu_plain_row_base_is_the_rows_of_a_whole_launch(t, m, k, n_buses, r, n):
    a_t, delta, mask, kw = _emu_case(t, m, k, n_buses=n_buses)
    n = min(n, t - r)
    whole = em.emu_bank_product_cuda(a_t, delta, mask, **kw)
    part = em.emu_bank_product_cuda(a_t[r:r + n].contiguous(), delta, mask, row_base=r, **kw)
    assert torch.equal(part, whole[r:r + n])
    assert torch.equal(part, em.emu_bank_product_plain(a_t[r:r + n], delta, mask,
                                                        row_base=r, **kw))


def test_emu_row_base_past_the_counters_raises():
    a_t, delta, mask, kw = _emu_case(4, 24, 40)
    rows = delta.shape[-3]
    em.check_operands(a_t, delta, mask, kw["n_panels"], kw["seed"], (1 << 32) // rows - 4)
    with pytest.raises(ValueError, match="row_base"):
        em.emu_bank_product_cuda(a_t, delta, mask, row_base=(1 << 32) // rows - 3, **kw)
    with pytest.raises(ValueError, match="row_base"):
        em.emu_bank_product_cuda(a_t, delta, mask, row_base=-1, **kw)


def test_a_world_of_one_trains_bit_for_bit():
    """data_parallel=True without a launcher: a world of one rank (gloo on
    the CPU); its steps equal the single-device path's bit for bit, and the
    group is torn down after."""
    import torch.distributed as dist

    from repro_torch.data import mnist

    x, y = mnist.procedural_digits(32, seed=1)
    batch = {"x": x[:, :64], "y": y}
    states = {}
    try:
        for dp in (False, True):
            s = api.build_session(arch="mnist_mlp", smoke=True, hardware="offchip_bpd",
                                  backend="cuda", data_parallel=dp, device="cpu")
            assert (s.mesh is not None) == dp
            state = s.init_state()
            for _ in range(2):
                state, metrics = s.step(state, batch)
            states[dp] = (state, float(metrics["loss"]))
        mesh = s.mesh
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert states[False][1] == states[True][1]
    for k, v in states[False][0]["params"].items():
        assert torch.equal(v, states[True][0]["params"][k]), k
