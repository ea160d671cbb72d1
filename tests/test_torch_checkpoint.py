"""The port's checkpointing (``repro_torch.train.checkpoint``) and crash
resume: tests/test_checkpoint.py's contract — roundtrip, dtype cast,
keep-k, atomic write, bit-exact resume — on the MLP, on the smoke LM and
on the emulated banks' hardware state."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.data import mnist, pipeline, tokens  # noqa: E402
from repro_torch.models.mlp import MLPClassifier  # noqa: E402
from repro_torch.train import SGDM, Trainer  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32), "step": 7},
            "l": [torch.ones(2), 3.5]}


def _assert_equal(x, y):
    if isinstance(x, dict):
        assert sorted(x) == sorted(y)
        for k in x:
            _assert_equal(x[k], y[k])
    elif isinstance(x, (list, tuple)):
        assert type(x) is type(y) and len(x) == len(y)
        for a, b in zip(x, y):
            _assert_equal(a, b)
    elif isinstance(x, torch.Tensor):
        assert x.dtype == y.dtype and torch.equal(x, y)
    else:
        assert type(x) is type(y) and x == y


def test_save_load_roundtrip(tmp_path):
    tree = _tree()
    path = str(tmp_path / "t.pt")
    ckpt.save(path, tree, step=7)
    loaded, step = ckpt.load(path, template=tree)
    assert step == 7
    _assert_equal(loaded, tree)
    flat, _ = ckpt.load(path)  # without a template: the flat names
    assert sorted(flat) == ["a", "b/c", "b/step", "l#0", "l#1"]


def test_flat_names_are_the_references(tmp_path):
    """The leaves are named as the reference names them (the file formats
    differ: the port's is its own)."""
    tree = _tree()
    assert sorted(ckpt._flatten(tree)) == sorted(jckpt._flatten(tree))


def test_dtype_cast_on_restore(tmp_path):
    path = str(tmp_path / "t.pt")
    ckpt.save(path, {"w": torch.ones(4), "step": 2})
    loaded, _ = ckpt.load(path, template={"w": torch.zeros(4, dtype=torch.bfloat16),
                                          "step": 0})
    assert loaded["w"].dtype == torch.bfloat16 and torch.equal(loaded["w"].float(),
                                                               torch.ones(4))
    assert loaded["step"] == 2


def test_restore_checks_the_template(tmp_path):
    path = str(tmp_path / "t.pt")
    ckpt.save(path, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="missing"):
        ckpt.load(path, template={"w": torch.ones(4), "v": torch.ones(1)})
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.load(path, template={"w": torch.ones(5)})


def test_manager_keep_k(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None and mgr.restore({"x": torch.zeros(1)}) == (None, None)
    for s in [10, 20, 30, 40]:
        mgr.save(s, {"x": torch.full((1,), float(s))})
    assert mgr.all_steps() == [30, 40]
    assert mgr.latest_step() == 40
    tree, step = mgr.restore({"x": torch.zeros(1)})
    assert step == 40 and float(tree["x"]) == 40.0
    tree, step = mgr.restore({"x": torch.zeros(1)}, step=30)
    assert step == 30 and float(tree["x"]) == 30.0


def test_atomic_write_never_leaves_partial(tmp_path):
    path = str(tmp_path / "c.pt")
    ckpt.save(path, {"x": torch.zeros(1000)})
    assert not os.path.exists(path + ".tmp")
    assert os.listdir(tmp_path) == ["c.pt"]
    # a crash mid-write leaves a stray temporary file, never a torn snapshot:
    # the manager sees only whole snapshots
    mgr = ckpt.CheckpointManager(str(tmp_path / "m"), keep=3)
    mgr.save(1, {"x": torch.ones(3)})
    with open(mgr._path(2) + ".tmp", "wb") as f:
        f.write(b"partial")
    assert mgr.all_steps() == [1]
    assert torch.equal(mgr.restore({"x": torch.zeros(3)})[0]["x"], torch.ones(3))


def _assert_states_equal(a, b):
    assert a["step"] == b["step"] and a["opt"]["step"] == b["opt"]["step"]
    for group in ("params", "fb"):
        for k in a[group]:
            assert torch.equal(a[group][k], b[group][k]), (group, k)
    for k in a["opt"]["mom"]:
        assert torch.equal(a["opt"]["mom"][k], b["opt"]["mom"][k]), k
    assert ("hw" in a) == ("hw" in b)
    for k in a.get("hw", {}):
        assert torch.equal(a["hw"][k], b["hw"][k]), k


def _crash_resume(tmp_path, make, data_fn, steps=6, cut=3):
    """A straight run of ``steps`` against one cut at ``cut`` and resumed
    by a new Trainer from the snapshot it left."""
    state_a, _ = make(str(tmp_path / "a"), 100).fit(data_fn, total_steps=steps, verbose=False)
    make(str(tmp_path / "b"), cut).fit(data_fn, total_steps=cut, verbose=False)
    resumed = make(str(tmp_path / "b"), cut)
    start_state, start = resumed.restore_or_init()
    assert start == cut and start_state["step"] == cut
    state_b, _ = resumed.fit(data_fn, total_steps=steps, verbose=False)
    assert state_a["step"] == state_b["step"] == steps
    _assert_states_equal(state_a, state_b)
    return state_a


@pytest.mark.parametrize("hardware,backend", [("offchip_bpd", "cuda"), ("emu_onchip", "emu")])
def test_crash_resume_is_bit_exact_mlp(tmp_path, hardware, backend):
    """6 steps straight against 3 + a crash + 3 resumed, on noisy banks:
    identical bits (the emu run carries and restores ``state["hw"]``, with
    a recalibration sweep on each side of the cut)."""
    x, y = mnist.procedural_digits(512, seed=0)
    pipe = pipeline.ArrayClassification(x[:, :64], y, batch_size=32, seed=0)

    def make(directory, every):
        model = MLPClassifier(in_dim=64, hidden=(32,), device="cpu")
        s = api.build_session(arch=model, hardware=hardware, backend=backend,
                              optimizer=SGDM(lr=0.01, momentum=0.9), seed=5,
                              recalibrate_every=2, device="cpu")
        return Trainer(model, dataclasses.replace(s.config, ckpt_dir=directory,
                                                  ckpt_every=every, log_every=10**9),
                       device="cpu")

    state = _crash_resume(tmp_path, make, pipe.batch)
    assert ("hw" in state) == (backend == "emu")


def test_crash_resume_is_bit_exact_lm(tmp_path):
    """The smoke LM on offchip_bpd (the bank kernel's plain version with
    noise), 6 steps straight against 3 + a crash + 3 resumed."""
    gen = tokens.MarkovTokens(128, 16, 4, seed=0)

    def make(directory, every):
        s = api.build_session(arch="qwen1.5-0.5b", smoke=True, hardware="offchip_bpd",
                              backend="cuda", seed=3, ckpt_dir=directory, ckpt_every=every,
                              log_every=10**9, device="cpu")
        return s.trainer

    _crash_resume(tmp_path, make, gen.batch)


def test_fit_saves_every_and_at_the_end(tmp_path):
    gen = tokens.MarkovTokens(128, 8, 2, seed=0)
    s = api.build_session(arch="qwen1.5-0.5b", smoke=True, ckpt_dir=str(tmp_path),
                          ckpt_every=2, log_every=10**9, device="cpu")
    assert s.config.ckpt_every == 2 and s.config.keep_ckpts == 3
    s.fit(gen.batch, total_steps=5, verbose=False)
    assert s.trainer.ckpt.all_steps() == [2, 4, 5]
    state, _ = s.fit(gen.batch, total_steps=5, verbose=False)  # nothing left to run
    assert state["step"] == 5
    flat, step = ckpt.load(s.trainer.ckpt._path(5))
    assert step == 5 and flat["step"] == 5
    assert {"params/embed.tok.table", "fb/embed", "opt/mom/head.out.weight"} <= set(flat)
    assert np.isfinite(flat["params/head.out.weight"].numpy()).all()
