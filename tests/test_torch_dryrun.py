"""The port's dry-run (``launch/dryrun.py``) and its collective record
(``utils/hlo.py``) on the CPU.

* ``serve.decode.cache_shardings`` gives every leaf of every arch's
  full-width ``decode_32k`` and ``long_500k`` caches (built on the meta
  device) the reference's PartitionSpec, on (16, 16) and (2, 16, 16); the
  reference's run in its own process on 512 forced host devices
  (``tests/_cache_spec_reference.py``).
* ``run_cell`` on a fake (2, 2) world (``tests/_dryrun_fake.py``, its own
  process) and on a real (2, 2) world of four gloo ranks (one spawn,
  scenario "dryrun"), for the smoke models' train, prefill and decode cells
  at reduced shapes: the FLOPs and the collective bytes and counts by kind
  equal, and in both the record of dispatched c10d ops (``utils/hlo``)
  equals ``step_cost``'s count at the port's helpers.
* ``shape_bytes`` against the reference's for the shared dtypes; the
  record's kinds and ``count_op``; the ``long_500k`` skip record;
  ``main``'s resume from ``--out``; the ``opt`` variant's models,
  ``freeze_norms`` and kimi-k2's microbatches."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _dist_ranks as ranks  # noqa: E402
from repro.utils import hlo as jhlo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.serve import decode as sd  # noqa: E402
from repro_torch.utils import hlo  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    [HERE, os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]))
# [arch, shape name, kind, seq_len, global_batch, mesh kind]: smoke cells
CELLS = [[arch, name, kind, seq, batch, "2x2"]
         for arch in ("qwen1.5-0.5b", "qwen2-moe-a2.7b", "mamba2-130m", "whisper-small")
         for name, kind, seq, batch in (("train_4k", "train", 16, 8),
                                        ("prefill_32k", "prefill", 16, 4),
                                        ("decode_32k", "decode", 32, 4))]
IDS = [f"{c[0]}-{c[2]}" for c in CELLS]


class _Mesh:
    """A production mesh's axis names and sizes (all ``cache_spec`` reads)."""

    def __init__(self, shape):
        self.shape = shape
        self.mesh_dim_names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The fake world's records and the real world's, by cell."""
    tmp = tmp_path_factory.mktemp("dryrun")
    src, dst = str(tmp / "cells.json"), str(tmp / "fake.json")
    with open(src, "w") as f:
        json.dump(CELLS, f)
    fake = subprocess.Popen([sys.executable, os.path.join(HERE, "_dryrun_fake.py"), src, dst],
                            env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        (real, *_) = ranks.spawn("dryrun", 4, timeout=300, cells=CELLS)
    finally:
        log = fake.communicate(timeout=300)[0].decode()
    assert fake.returncode == 0, log[-3000:]
    with open(dst) as f:
        return json.load(f), real


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("specs") / "specs.json")
    run = subprocess.run([sys.executable, os.path.join(HERE, "_cache_spec_reference.py"), out],
                         env=ENV, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _norm(spec) -> list:
    return [None if e is None else list(e) if isinstance(e, tuple) else [e] for e in spec]


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", list(configs.ASSIGNED))
def test_cache_shardings_match_reference(reference_specs, arch, shape):
    case = configs.SHAPES[shape]
    caches = configs.get(arch).make_model(torch.bfloat16, device="meta").init_caches(
        case.global_batch, case.seq_len)
    paths = {k.replace(".", "/"): v for k, v in caches.items()}  # the reference's nesting
    for mesh_kind, shp in (("single", (16, 16)), ("multi", (2, 16, 16))):
        mesh = _Mesh(shp)
        for path, leaf in paths.items():
            want = reference_specs[f"{mesh_kind}|{arch}|{shape}|{path}"]
            assert list(leaf.shape) == want["shape"], (path, leaf.shape)
            assert _norm(sd.cache_spec(mesh, tuple(leaf.shape))) == want["spec"], (
                mesh_kind, path)
        assert len([k for k in reference_specs if k.startswith(f"{mesh_kind}|{arch}|{shape}|")]
                   ) == len(paths)


@pytest.mark.parametrize("cell", range(len(CELLS)), ids=IDS)
def test_fake_world_counts_equal_real_world(cells, cell):
    fake, real = cells[0][cell], cells[1][cell]
    for rec in (fake, real):
        assert rec["status"] == "ok", rec.get("traceback")
    assert fake["cost"]["flops"] == real["cost"]["flops"]
    assert fake["cost"]["bytes accessed"] == real["cost"]["bytes accessed"]
    assert fake["hlo_cost"]["coll_bytes_by_kind"] == real["hlo_cost"]["coll_bytes_by_kind"]
    assert fake["collectives"] == real["collectives"]
    assert fake["argument_bytes"] == real["argument_bytes"]
    assert fake["memory"]["total_hbm_bytes"] >= fake["argument_bytes"] > 0
    assert fake["chips"] == real["chips"] == 4


@pytest.mark.parametrize("cell", range(len(CELLS)), ids=IDS)
def test_collective_record_equals_step_cost(cells, cell):
    """``utils/hlo``'s record of the dispatched c10d ops against
    ``step_cost``'s count at the port's helpers, fake and real; every
    sharded cell issues collectives."""
    for rec in (cells[0][cell], cells[1][cell]):
        assert rec["collectives_agree"], rec["collectives"]
        assert rec["collectives"]["bytes_by_kind"] == {
            k: int(v) for k, v in rec["hlo_cost"]["coll_bytes_by_kind"].items() if v}
        assert rec["collectives"]["total_count"] > 0


@pytest.mark.parametrize("dtype,name", [(d, n) for d, n in hlo.TORCH_NAMES.items()])
def test_shape_bytes_matches_reference(dtype, name):
    assert hlo.shape_bytes(dtype, (3, 5, 7)) == jhlo.shape_bytes(name, "3,5,7")
    assert hlo.shape_bytes(name, "3,5,7") == jhlo.shape_bytes(name, "3,5,7")
    assert hlo.shape_bytes(dtype, ()) == jhlo.shape_bytes(name, "")


def test_record_kinds_and_count_op():
    """The dispatch record names every operation; a collective's operand
    bytes go to its reference kind (``analyze_collectives``)."""
    rec = hlo.Record()
    rec.collectives += [("all-gather", 64, "c10d::_allgather_base_"),
                        ("all-reduce", 4, "c10d::allreduce_"),
                        ("all-gather", 32, "c10d::_allgather_base_")]
    stats = hlo.analyze_collectives(rec)
    assert dict(stats.bytes_by_kind) == {"all-gather": 96, "all-reduce": 4}
    assert dict(stats.count_by_kind) == {"all-gather": 2, "all-reduce": 1}
    assert (stats.total_bytes, stats.total_count) == (100, 3)
    assert set(stats.bytes_by_kind) <= set(jhlo._COLLECTIVES)
    with hlo.record() as mode:
        torch.ones(4, 3) @ torch.ones(3, 2)
    assert hlo.count_op(mode.rec, "mm") == 1
    assert hlo.count_op(mode.rec, "aten::mm") == 1
    assert mode.rec.collectives == []


def test_long_500k_skip_record():
    rec = dryrun.run_cell("qwen1.5-0.5b", "long_500k", "single")
    assert rec == {"arch": "qwen1.5-0.5b", "shape": "long_500k", "mesh": "single",
                   "kind": "decode", "variant": "baseline", "status": "skip",
                   "reason": "full-attention arch: 512k dense-KV decode is infeasible by "
                             "design (DESIGN.md §6)"}
    assert [a for a in configs.ASSIGNED if configs.get(a).sub_quadratic] == [
        "mamba2-130m", "recurrentgemma-9b"]


def test_main_resumes_from_out(tmp_path, capsys):
    """A cell already ``ok`` in ``--out`` is not run again; the others are
    recorded beside it (the skip costs no trace)."""
    out = tmp_path / "dryrun.json"
    done = {"arch": "qwen1.5-0.5b", "shape": "train_4k", "mesh": "single", "kind": "train",
            "variant": "baseline", "status": "ok", "seconds": 1.0}
    out.write_text(json.dumps([done]))
    code = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "long_500k",
                        "--mesh", "single", "--out", str(out)])
    assert code == 0
    assert "[skip-done]" in capsys.readouterr().out
    recs = json.loads(out.read_text())
    assert recs[0] == done
    assert [(r["shape"], r["status"]) for r in recs] == [("train_4k", "ok"),
                                                         ("long_500k", "skip")]


def test_opt_variant():
    """``--variant opt``: each arch's ``make_opt`` config where it has one,
    the norm scales frozen, kimi-k2's training step in 4 microbatches; the
    baseline otherwise."""
    with_opt = [a for a in configs.ASSIGNED if configs.get(a).make_opt is not None]
    assert with_opt == ["minicpm3-4b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "mamba2-130m",
                        "internvl2-2b", "whisper-small"]
    try:
        dryrun.VARIANT["name"] = "opt"
        assert dryrun._dfa_config().freeze_norms
        assert dryrun._microbatches(configs.get("kimi-k2-1t-a32b")) == 4
        assert dryrun._microbatches(configs.get("qwen2-moe-a2.7b")) == 1
        for arch in configs.ASSIGNED:
            a = configs.get(arch)
            got = dryrun._make_model(a, device="meta").cfg
            want = (a.make_opt or a.make_model)(torch.bfloat16, device="meta").cfg
            assert got == want, arch
        assert dryrun._make_model(configs.get("mamba2-130m"), device="meta").cfg.split_proj
    finally:
        dryrun.VARIANT["name"] = "baseline"
    assert not dryrun._dfa_config().freeze_norms
    assert dryrun._microbatches(configs.get("kimi-k2-1t-a32b")) == 1
    assert not dryrun._make_model(configs.get("mamba2-130m"), device="meta").cfg.split_proj
