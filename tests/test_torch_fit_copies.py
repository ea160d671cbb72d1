"""The f32 copies of the parameters a ``Trainer.fit`` update holds: five,
as the reference's functional update (the parameters, their momentum, the
gradients, the new parameters and the new momentum), not a sixth, the
module's own: during a fit the module's parameters share the state's
storage (``DFAModel.adopt``).  Counted by the live f32 storages of the
largest parameter's size at the end of every ``SGDM.update`` of a fit, on
the smoke qwen1.5 and the smoke mnist_mlp.  After the fit the session
serves the trained parameters, and a later ``init_state`` or ``engine``
leaves the fit's state as it was (``DFAModel.own_storage``)."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.serve import Request  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402

STEPS = 3


def _data(arch):
    rng = np.random.default_rng(0)
    if arch == "mnist_mlp":
        return lambda i: {"x": rng.normal(size=(8, 64)).astype(np.float32),
                          "y": rng.integers(0, 10, 8)}
    return lambda i: {"tokens": rng.integers(0, 128, (2, 8)),
                      "labels": rng.integers(0, 128, (2, 8))}


def _live(size: int) -> set:
    """The live f32 storages of ``size`` bytes in the process."""
    gc.collect()
    return {o.untyped_storage().data_ptr() for o in gc.get_objects()
            if type(o) in (torch.Tensor, torch.nn.Parameter) and o.dtype == torch.float32
            and o.untyped_storage().nbytes() == size}


@pytest.mark.parametrize("arch", ["mnist_mlp", "qwen1.5-0.5b"])
def test_a_fit_update_holds_five_f32_copies(arch, monkeypatch):
    """At the end of each update: the live storages of the largest
    parameter's size, less those alive before the fit that are not the
    module's (another test's), per parameter of that size."""
    counts = []
    update = opt_mod.SGDM.update
    s = api.build_session(arch=arch, smoke=True, device="cpu", log_every=10**9)
    sizes = [p.untyped_storage().nbytes() for p in s.model.parameters()]
    size = max(sizes)
    module = {p.untyped_storage().data_ptr() for p in s.model.parameters()}
    stale = _live(size) - module

    def counted(self, grads, state, params):
        out = update(self, grads, state, params)
        counts.append(len(_live(size) - stale) / sizes.count(size))
        return out

    monkeypatch.setattr(opt_mod.SGDM, "update", counted)
    s.fit(_data(arch), STEPS, verbose=False)
    assert len(counts) == STEPS
    # five, and not six (the smoke LM holds one more tensor of that size
    # than its parameters of that size: an eighth)
    assert all(5 <= c < 6 for c in counts), counts


def test_the_session_serves_the_trained_parameters_after_fit():
    arch = "qwen1.5-0.5b"
    s = api.build_session(arch=arch, smoke=True, device="cpu", log_every=10**9, algo="dfa")
    init = {k: v.clone() for k, v in s.init_state()["params"].items()}
    state, _ = s.fit(_data(arch), STEPS, verbose=False)
    trained = {k: v.clone() for k, v in state["params"].items()}
    assert any(not torch.equal(trained[k], init[k]) for k in init)
    # the module holds what the fit trained
    assert all(torch.equal(p, trained[k]) for k, p in s.model.named_parameters())
    # a new state leaves the fit's state as it was
    s.init_state()
    assert all(torch.equal(state["params"][k], trained[k]) for k in trained)

    def tokens(engine):
        (req,), _ = engine.run([Request(prompt=[5, 9, 2, 7], max_new=6)])
        return req.out

    # the session's engine serves the trained parameters: the tokens of a
    # fresh session's engine on the same parameters
    got = s.engine(state["params"], batch_slots=2, max_len=32)
    assert all(torch.equal(p, trained[k]) for k, p in got.model.named_parameters())
    other = api.build_session(arch=arch, smoke=True, device="cpu", log_every=10**9, seed=3)
    want = other.engine(trained, batch_slots=2, max_len=32)
    assert tokens(got) == tokens(want) != []
    # and a fresh draw for the engine leaves the fit's state as it was
    s.engine(batch_slots=2, max_len=32)
    assert all(torch.equal(state["params"][k], trained[k]) for k in trained)
