"""Tensor parallelism on the ``model`` axis for the families beyond the
dense transformers: ``launch/dryrun.build_train``'s sharded step on four
gloo ranks on the CPU against the port's one process and the reference's
sharded step.

One spawn of four ranks (``tests/_dist_ranks.py``, scenario
"tp_families") runs every check and returns its numbers; the reference's
sharded step runs at the same time in its own process on four forced host
devices (``tests/_fsdp_reference.py``).  On (1, 2): the smoke qwen2-moe
(expert parallel: each rank runs 4 of its 8 experts), minicpm3 (MLA),
mamba2, recurrentgemma, whisper and internvl2 with its vision prefix; on
(1, 4) qwen2-moe again (2 experts a rank).  For each: the loss and every
gradient leaf within 1e-5 of its max |g| of the port's one process (noise
off, and on: offchip_bpd in input mode) and of the reference's sharded
step (noise off); every piece after two noisy steps the rule's slice of
the one process's parameters.  The MoE's expert products: each rank holds
E/m experts and ``step_cost`` counts 1/m of one process's expert FLOPs,
and the collective bytes it counts are those handed to
``torch.distributed``.  On (1, 2) the emu backend's step (the unfused
chain and the emu kernel's plain version, the feedback's rows sharing a
bank panel across the ranks) and dfa-layerwise's gradients against one
process; on both meshes a rank's columns of an emu product against the
one process's columns, bit for bit through the kernel's plain version."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as ranks  # noqa: E402
from test_torch_fsdp import _case, _flatten, _nest, _one_process, _worst  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.utils import flop_cost  # noqa: E402

WORLD = 4
TOL = 1e-5  # loss and gradients of a step (ROADMAP)
PAIRS = [(mesh, arch) for mesh, archs in ranks.TPF_ARCHS.items() for arch in archs]
SEEDS = {arch: 10 + i for i, arch in enumerate(ranks.TPF_ARCHS["tp12"])}
DENSE = "qwen1.5-0.5b"  # the emu and dfa-layerwise steps
HERE = os.path.dirname(os.path.abspath(__file__))


def _reference_inputs(path, ref_cases):
    data = {}
    for mesh, arch in PAIRS:
        case = f"{mesh}-{arch}"
        data[f"{case}|arch"], data[f"{case}|mesh"] = np.array(arch), np.array(mesh)
        for what in ("params", "fb", "batch"):
            for k, v in _flatten(ref_cases[arch][what]).items():
                data[f"{case}|{what}|{k}"] = v.astype(np.int32) if v.dtype.kind in "iu" else v
    np.savez(path, **data)


def _one_process_steps(arch, case):
    """The one process's parameters after two noisy trainer steps (keys
    step_key(0, i, "noise"), as the ranks' steps)."""
    s = ranks.session(False, arch=arch, smoke=True, hardware="offchip_bpd", backend="cuda")
    state = ranks.load_state(s, case["params"], case["fb"])
    for _ in range(ranks.TP_STEPS):
        state, _ = s.step(state, case["batch"])
    return ranks.np_tree(state["params"])


def _one_process_expert_flops(case):
    s = ranks.session(False, arch=ranks.TPF_MOE, smoke=True, hardware="offchip_bpd",
                      backend="cuda")
    st = ranks.load_state(s, case["params"], case["fb"])
    _, cost = flop_cost.measure(s.trainer._grads, st["params"], st["fb"],
                                s.trainer.put(case["batch"]), 7)
    return cost.region_flops["experts"]


@pytest.fixture(scope="module")
def tpf(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tpf")
    ref_cases, cases = {}, {}
    for arch, seed in SEEDS.items():
        ref_cases[arch], cases[arch] = _case(arch, seed)
    _, dense = _case(DENSE, 0)
    ref_in, ref_out = str(tmp / "ref_in.npz"), str(tmp / "ref_out.npz")
    _reference_inputs(ref_in, ref_cases)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "_fsdp_reference.py"), ref_in,
                             ref_out], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    threads = torch.get_num_threads()
    try:
        out = ranks.spawn("tp_families", WORLD, cases=cases, emu={"arch": DENSE, **dense},
                          layerwise={"arch": DENSE, **dense})
        # one thread, as each rank runs: the CPU's GEMMs then split their work
        # alike on both sides
        torch.set_num_threads(1)
        one = {(arch, hw): _one_process(arch, hw, cases[arch])
               for arch in SEEDS for hw in ranks.FSDP_HARDWARE}
        steps = {arch: _one_process_steps(arch, cases[arch]) for arch in SEEDS}
        emu = {}
        for kernel in ranks.TPF_EMU_KERNELS:
            s = ranks.session(False, arch=DENSE, smoke=True, hardware="emu_offchip",
                              backend="emu", emu_kernel=kernel)
            emu[kernel] = ranks.grads_of(s, ranks.load_state(s, dense["params"], dense["fb"]),
                                         dense["batch"])
        s = ranks.session(False, arch=DENSE, smoke=True, hardware="offchip_bpd", backend="cuda",
                          algo="dfa-layerwise")
        layerwise = ranks.grads_of(s, ranks.load_state(s, dense["params"], dense["fb"]),
                                   dense["batch"])
        experts = _one_process_expert_flops(cases[ranks.TPF_MOE])
        _, stderr = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, stderr[-3000:]
    return {"cases": cases, "ranks": out, "one": one, "steps": steps, "emu": emu,
            "layerwise": layerwise, "experts": experts, "ref": dict(np.load(ref_out))}


@pytest.mark.parametrize("hardware", ranks.FSDP_HARDWARE)
@pytest.mark.parametrize("mesh,arch", PAIRS)
def test_sharded_step_equals_one_process(tpf, mesh, arch, hardware):
    loss, grads = tpf["ranks"][0]["grads"][mesh, arch, hardware]
    one_loss, _, one_grads = tpf["one"][arch, hardware]
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(grads, one_grads, arch) <= TOL


@pytest.mark.parametrize("mesh,arch", PAIRS)
def test_sharded_step_equals_the_references_sharded_step(tpf, mesh, arch):
    case = f"{mesh}-{arch}"
    ref = tpf["ref"]
    jgrads = _nest({k[len(case) + len("|grads|"):]: v for k, v in ref.items()
                    if k.startswith(f"{case}|grads|")})
    expect = {k: v.numpy() for k, v in convert.state_dict_from_reference(jgrads).items()}
    loss, grads = tpf["ranks"][0]["grads"][mesh, arch, "ideal"]
    ref_loss = float(ref[f"{case}|loss"])
    assert loss == pytest.approx(ref_loss, abs=TOL * abs(ref_loss))
    assert _worst(grads, expect, arch) <= TOL


@pytest.mark.parametrize("mesh,arch", PAIRS)
def test_every_piece_after_two_steps_is_the_rules_slice(tpf, mesh, arch):
    """Every rank's piece of every leaf after two noisy steps = the rule's
    slice of the one process's parameters (within 1e-5 of its max); some
    leaves are split."""
    n = int(np.prod(ranks.TP_MESHES[mesh]))
    steps = tpf["steps"][arch]
    split = 0
    for r in range(n):
        for k, (piece, index) in tpf["ranks"][r]["shards"][mesh, arch].items():
            expect = steps[k][index]
            assert piece.shape == expect.shape, k
            assert np.abs(piece - expect).max() <= TOL * np.abs(steps[k]).max(), (r, k)
            split += piece.shape != steps[k].shape
    assert split > 0


@pytest.mark.parametrize("mesh", list(ranks.TPF_ARCHS))
def test_each_rank_holds_and_computes_its_experts(tpf, mesh):
    """Expert parallel: every stacked expert weight holds E/m experts on
    each rank, and ``step_cost`` counts 1/m of one process's expert FLOPs
    there (forward, recompute and backward)."""
    m = ranks.TP_MESHES[mesh][1]
    n_experts = tpf["cases"][ranks.TPF_MOE]["params"]["blocks.0.ffn.experts.gate.weight"].shape[0]
    for r in range(m):
        got = tpf["ranks"][r]["moe"][mesh]
        assert got["local_experts"] and set(got["local_experts"].values()) == {n_experts // m}
        assert got["experts"] * m == tpf["experts"], (r, got["experts"], tpf["experts"])


@pytest.mark.parametrize("mesh", list(ranks.TPF_ARCHS))
def test_moe_step_cost_counts_the_bytes_handed_to_torch_distributed(tpf, mesh):
    for r in range(ranks.TP_MESHES[mesh][1]):
        got = tpf["ranks"][r]["moe"][mesh]
        assert got["counted"] == got["seen"] and got["counted"]["all-gather"] > 0, r


@pytest.mark.parametrize("kernel", ranks.TPF_EMU_KERNELS)
def test_the_emu_step_equals_one_process(tpf, kernel):
    """The emu backend on (1, 2): each rank projects its rows of B(k), the
    columns of bank panels it shares with the other rank widened to the
    whole panels, in its column window; loss and gradients against one
    process at the same hardware state."""
    loss, grads = tpf["ranks"][0]["emu"][kernel]
    one_loss, _, one_grads = tpf["emu"][kernel]
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(grads, one_grads, DENSE) <= TOL


def test_dfa_layerwise_equals_one_process(tpf):
    loss, grads = tpf["ranks"][0]["layerwise"]
    one_loss, _, one_grads = tpf["layerwise"]
    assert loss == pytest.approx(one_loss, abs=TOL * abs(one_loss))
    assert _worst(grads, one_grads, DENSE) <= TOL


@pytest.mark.parametrize("mesh,case", [(mesh, case) for mesh, cases in
                                       ranks.TPF_EMU_COLUMNS.items() for case in cases])
def test_a_ranks_emu_columns_are_the_one_process_columns(tpf, mesh, case):
    """A rank's columns of an emu product (its rows of B, whose first or
    last bank panel it shares with a neighbour) equal the one process's
    columns bit for bit through the emu kernel's plain version, and within
    1e-6 through the unfused chain (whose CPU einsum rounds a product of
    fewer panels differently).  Every rank returns (none waits on a
    gather another skipped), also where only the last rank's window ends
    on a panel's edge."""
    _, rows = case
    for r in range(ranks.TP_MESHES[mesh][1]):
        got = tpf["ranks"][r]["emu_columns"][mesh][case]
        assert got["cuda"] == (True, 0.0), (r, got)
        assert got["ref"][1] <= 1e-6, (r, got)
    starts = {tpf["ranks"][r]["emu_columns"][mesh][case]["window"][0] % rows
              for r in range(ranks.TP_MESHES[mesh][1])}
    assert starts - {0}  # some rank starts inside a panel


# ---------------------------------------------------------------------------
# without the spawn: the emu kernel's column base
# ---------------------------------------------------------------------------


def _emu_operands(t, k, m, n_buses):
    from repro_torch.core import photonics as ph
    from repro_torch.hardware import channel, mrr

    cfg = ph.PhotonicConfig(noise_std=0.202, n_buses=n_buses,
                            mrr=mrr.MRRConfig(adc_bits=8, shot_noise=0.05))
    g = torch.Generator().manual_seed(t + k + m)
    a = torch.rand((t, k), generator=g) * 2 - 1
    b = torch.rand((m, k), generator=g) * 2 - 1
    a_t, b_t, n_panels = channel.tile_operands(a, b, cfg)
    delta = channel.effective_deltas(b_t, cfg).contiguous()
    kw = dict(n_panels=n_panels, gamma=float(cfg.mrr.gamma), sigma=0.202, shot=0.05,
              adc_bits=8, amax=float(cfg.bank_cols), seed=(0x1234ABCD, 0x0BADF00D))
    return a_t, delta, channel.alive_dead_ring_mask(cfg, "cpu"), kw


@pytest.mark.parametrize("t,k,m,n_buses,panel,r", [(6, 40, 130, 1, 1, 0), (5, 70, 160, 2, 2, 3),
                                                    (4, 30, 100, 1, 1, 1)])
def test_plain_versions_panels_are_the_whole_products_columns(t, k, m, n_buses, panel, r):
    """The emu kernel's plain version on panels [p, nm) of the weight with
    col_base = p·rows (and rows [r, T) with row_base = r) = those columns
    and rows of the whole product's plain version, bit for bit: a
    tensor-parallel rank's columns draw the global product's noise."""
    from repro_torch.kernels import emu_matmul as em

    a_t, delta, mask, kw = _emu_operands(t, k, m, n_buses)
    rows = delta.shape[-3]
    whole = em.emu_bank_product_plain(a_t, delta, mask, **kw)
    part = em.emu_bank_product_cuda(a_t[r:].contiguous(), delta[panel:].contiguous(), mask,
                                    row_base=r, col_base=panel * rows, **kw)
    assert torch.equal(part, whole[r:, panel * rows:])
    # the columns' noise is not the first panels' (a rank without its base)
    assert not torch.equal(em.emu_bank_product_plain(a_t, delta[panel:].contiguous(), mask,
                                                     **kw), whole[:, panel * rows:])


def test_a_col_base_past_the_slot_counters_raises():
    from repro_torch.kernels import emu_matmul as em

    a_t, delta, mask, kw = _emu_operands(4, 1024, 100, 1)
    nm, q, rows, nj, _c = delta.shape
    top = (em.COUNTER_SLOTS // (q * nj) - nm) * rows  # the last base whose counters fit
    em.check_operands(a_t, delta, mask, kw["n_panels"], kw["seed"], col_base=top)
    with pytest.raises(ValueError, match="slot counters"):
        em.check_operands(a_t, delta, mask, kw["n_panels"], kw["seed"], col_base=top + rows)
