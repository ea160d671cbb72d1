"""The emu kernel's planner (``emu_matmul._plan``): plain Python, so it runs
here without a card.  Which variant, rows per block and T tile each call of
the main path gets, and what the planner refuses."""

import math

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import emu_matmul as em  # noqa: E402

ROWS, COLS = 50, 20  # the paper's 50×20 bank
ALIGNED = (0x7F00_0000_0000, None)  # δ's address, no dead-ring mask
# (T, M, K, buses) of every launch of the main paths: path A's DFA projection,
# the reference's emu benchmark, and path B's four qwen1.5-0.5b bank products
# at decode (T = 4) and prefill (T = 64)
PATH_SHAPES = {
    "path_a": (64, 800, 10, 1),
    "benchmark": (64, 1024, 1024, 4),
    **{f"path_b_T{t}_{m}x{k}": (t, m, k, 1)
       for t in (4, 64) for (m, k) in ((1024, 1024), (2816, 1024), (1024, 2816),
                                      (151936, 1024))},
}


def _tiling(t, m, k, q):
    """(nm, nj) as channel.tile_operands tiles (T, K) x (M, K) on q buses."""
    nk = math.ceil(k / COLS)
    return math.ceil(m / ROWS), math.ceil(nk / q)


@pytest.mark.parametrize("shape", list(PATH_SHAPES))
def test_plan_fills_the_card_at_every_path_shape(shape):
    t, m, k, q = PATH_SHAPES[shape]
    nm, nj = _tiling(t, m, k, q)
    n_slots = q * nj
    plan = em._plan(t, nm, ROWS, q, nj, COLS, ALIGNED)
    assert plan.variant == em.VECTOR
    # a block for every SM of a 132-SM card
    assert em.grid_blocks(plan, t, nm, ROWS) >= em.CARD_SMS
    # within a block's shared memory, and two blocks fit an SM; whole warps,
    # at most 256 threads
    smem = em.smem_bytes(plan, q, nj, COLS)
    assert smem <= em.SMEM_MAX
    threads = em.threads_per_block(plan, q, nj)
    assert threads % 32 == 0 and 32 <= threads <= em.THREADS
    assert em._resident(threads, smem) >= 2
    # a block holds every slot of its rows (the slot axis is never split), at
    # most 8 tuples a thread
    tuples = plan.rows_per_block * n_slots
    assert tuples <= em.TUPLES or plan.rows_per_block == 1
    assert 8 * threads >= tuples
    # at decode one T tile holds all of T, so each weight is formed once
    if t <= em.DECODE_T:
        assert plan.t_tile == t
    assert 1 <= plan.t_tile <= t


def test_path_a_plan_one_slot_per_row():
    """Path A (K = 10: one panel, S = 1): each block owns whole rows, and
    the grid comes from rows and T tiles alone."""
    t, m, k, q = PATH_SHAPES["path_a"]
    nm, nj = _tiling(t, m, k, q)
    assert q * nj == 1
    plan = em._plan(t, nm, ROWS, q, nj, COLS, ALIGNED)
    assert plan.rows_per_block > 1 and plan.t_tile < t
    assert em.threads_per_block(plan, q, nj) == -(-plan.rows_per_block // 32) * 32
    assert em.grid_blocks(plan, t, nm, ROWS) == (math.ceil(nm * ROWS / plan.rows_per_block)
                                                 * math.ceil(t / plan.t_tile))


@pytest.mark.parametrize("pointers", [(0x7F00_0000_0004, None),
                                      (0x7F00_0000_0000, 0x7F00_0000_0008)])
def test_unaligned_operands_take_the_scalar_twin(pointers):
    plan = em._plan(4, 21, ROWS, 1, 52, COLS, pointers)
    assert plan.variant == em.SCALAR
    with pytest.raises(ValueError, match="16-byte"):
        em._check_plan(plan._replace(variant=em.VECTOR), 4, 1, 52, COLS, pointers)


@pytest.mark.parametrize("cols", [1, 3, 19, 21, 32, 33, 40, 64, 106])
def test_other_bank_widths_take_the_generic_variant(cols):
    plan = em._plan(4, 21, ROWS, 1, 52, cols, ALIGNED)
    assert plan.variant == em.GENERIC
    with pytest.raises(ValueError, match=f"C={em.BANK_COLS}"):
        em._check_plan(plan._replace(variant=em.VECTOR), 4, 1, 52, cols, ALIGNED)


def test_planner_refuses_what_no_plan_takes():
    # one T row of 3000 slots' inputs is 240 KB: more than a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        em._plan(1, 1, ROWS, 1, 3000, COLS, ALIGNED)
    # the same at 64 columns: 1000 slots are 256 KB
    with pytest.raises(ValueError, match="shared memory"):
        em._plan(1, 1, ROWS, 1, 1000, 64, ALIGNED)


@pytest.mark.parametrize("cols", [40, 64])
@pytest.mark.parametrize("t", [4, 64])
def test_wide_banks_plan_within_the_card(cols, t):
    """Banks wider than one 32-column chunk (PhotonicConfig.bank_cols is a
    setting) at a 1024×1024 layer: the generic variant, a plan that fits a
    block and fills the card."""
    nm, nj = math.ceil(1024 / ROWS), math.ceil(1024 / cols)
    plan = em._plan(t, nm, ROWS, 1, nj, cols, ALIGNED)
    assert plan.variant == em.GENERIC
    assert em.smem_bytes(plan, 1, nj, cols) <= em.SMEM_MAX
    assert em.grid_blocks(plan, t, nm, ROWS) >= em.CARD_SMS
    for other in em.candidate_plans(t, nm, ROWS, 1, nj, cols, ALIGNED):
        assert other.variant == em.GENERIC
        em._check_plan(other, t, 1, nj, cols, ALIGNED)


def test_check_plan_rejects_what_the_kernel_does_not_take():
    ok = em.Plan(em.VECTOR, 3, 4)
    em._check_plan(ok, 4, 1, 52, COLS, ALIGNED)
    for bad in (ok._replace(t_tile=5), ok._replace(t_tile=0), ok._replace(rows_per_block=0)):
        with pytest.raises(ValueError, match="T tile"):
            em._check_plan(bad, 4, 1, 52, COLS, ALIGNED)
    with pytest.raises(ValueError, match="shared memory"):
        em._check_plan(em.Plan(em.VECTOR, 1, 64), 64, 1, 141, COLS, ALIGNED)
    with pytest.raises(ValueError, match="C=20"):
        em._check_plan(em.Plan(em.SCALAR, 1, 1), 4, 1, 52, 40, ALIGNED)
    em._check_plan(em.Plan(em.GENERIC, 1, 1), 4, 1, 52, 40, ALIGNED)


def test_shared_memory_and_threads_of_a_plan():
    # T tile 4, 3 rows, 52 slots: the f32 input tile 4·52·20 floats and the
    # per-slot values 4·3·53 (an odd row stride)
    plan = em.Plan(em.VECTOR, 3, 4)
    assert em.smem_bytes(plan, 1, 52, COLS) == 4 * (4 * 52 * 20 + 4 * 3 * 53)
    # a T tile of 5 is computed 4 rows at a time: its input tile has 8 rows
    assert em.smem_bytes(em.Plan(em.VECTOR, 1, 5), 1, 6, COLS) == 4 * (8 * 6 * 20 + 5 * 7)
    # 156 tuples -> 160 threads; 988 -> 4 a thread over 256; 564 -> 3 a thread over 192
    # (each thread then does 3 tuples or 2)
    assert em.threads_per_block(plan, 1, 52) == 160
    assert em.threads_per_block(em.Plan(em.VECTOR, 19, 4), 1, 52) == 256
    assert em.threads_per_block(em.Plan(em.VECTOR, 4, 4), 1, 141) == 192
    assert em.threads_per_block(em.Plan(em.VECTOR, 1, 4), 1, 1) == 32


@pytest.mark.parametrize("pointers,variants", [
    (ALIGNED, {em.VECTOR, em.SCALAR, em.GENERIC}),
    ((0x7F00_0000_0004, None), {em.SCALAR, em.GENERIC}),
])
def test_candidate_plans_are_plans_the_kernel_takes(pointers, variants):
    t, nm, q, nj = 4, 21, 1, 141
    plans = em.candidate_plans(t, nm, ROWS, q, nj, COLS, pointers)
    assert plans[0] == em._plan(t, nm, ROWS, q, nj, COLS, pointers)
    assert len(set(plans)) == len(plans)
    assert {p.variant for p in plans} == variants
    assert {p.t_tile for p in plans} == {1, 4}
    assert {p.rows_per_block for p in plans} == {1, plans[0].rows_per_block,
                                                 2 * plans[0].rows_per_block}
    for plan in plans:
        em._check_plan(plan, t, q, nj, COLS, pointers)


def test_launch_refuses_cpu_tensors():
    import torch

    a_t = torch.zeros((4, 1, 1, COLS))
    delta = torch.zeros((1, 1, ROWS, 1, COLS))
    with pytest.raises(ValueError, match="device"):
        em.launch_kernel(a_t, delta, None, n_panels=1, gamma=1.0, sigma=0.0, shot=0.0,
                         adc_bits=None, amax=20.0)


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_draw_sass_is_read_by_function_and_opcode():
    """chip_smoke.py's PRNG bound reads one draw's instructions from the
    SASS of two probe kernels: the opcodes of each function, modifiers and
    predicates dropped."""
    cs = _chip_smoke()
    sass = """
        Function : probe_one_draw
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R0, c[0x0][0x160], RZ ;
        /*0020*/               @!P0 BRA `(.L_x_1) ;
        Function : probe_two_draws
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IADD3 R2, R0, c[0x0][0x160], RZ ;
        /*0020*/                   SHF.L.W.U32.HI R4, R2, 0xd, R2 ;
        /*0030*/                   LOP3.LUT R4, R4, R2, RZ, 0x3c, !PT ;
        /*0040*/                   IDP.2A.LO.U16.U8 R5, R4, 0x101, RZ ;
        /*0050*/               @P1 UIADD3 UR4, UR4, 0x1, URZ ;
        /*0060*/               @!P0 BRA `(.L_x_1) ;
"""
    assert cs._sass_opcodes(sass, "probe_one_draw") == {"MOV": 1, "IADD3": 1, "BRA": 1}
    assert cs._sass_opcodes(sass, "probe_two_draws") == {
        "MOV": 1, "IADD3": 1, "SHF": 1, "LOP3": 1, "IDP": 1, "UIADD3": 1, "BRA": 1}


@pytest.mark.parametrize("opcodes,clocks,by", [
    # threefry's rotates and xors only on the ALU pipe (64 a clock); its
    # adds go to whichever integer pipe is free
    ({"IADD3": 22, "SHF": 20, "LOP3": 20, "IDP": 2, "I2FP": 1, "FADD": 2, "FMUL": 1},
     41 / 64, "alu"),
    # one move fewer in the two-draw kernel nets out; NOPs are padding
    ({"IADD3": 20, "SHF": 30, "LOP3": 30, "MOV": -1, "NOP": 6}, 60 / 64, "alu"),
    # adds spread over both integer pipes: the issue rate binds (128 a clock)
    ({"IADD3": 60, "IMAD": 40, "LOP3": 20, "UIADD3": 4}, 124 / 128, "issue"),
    # dot products only on the FMA-heavy half (64 a clock)
    ({"IDP": 70, "FFMA": 10}, 70 / 64, "fma_heavy"),
    # a conversion unit at 16 a clock
    ({"I2F": 20, "IADD3": 20}, 20 / 16, "xu"),
])
def test_draw_cost_takes_the_busiest_pipe(opcodes, clocks, by):
    cost = _chip_smoke().draw_cost(opcodes)
    assert cost["by"] == by
    assert cost["clocks"] == pytest.approx(clocks)
