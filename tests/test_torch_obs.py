"""The port's spans, trace and training telemetry against the JAX
package's, on the CPU.

* ``obs.span`` records ``span_seconds{name}`` and
  ``span_host_seconds{name}``; ``device_sync`` walks nested containers.
* ``Telemetry`` after the same FullGD fit (the reference's initial state
  injected): the same counter, gauge and histogram names with the same
  counts, ``train_cost`` within 1e-4 relative; the ``fit.<schedule>``
  and ``gossip.rounds`` spans too.
* ``obs.trace`` writes a Chrome trace holding an annotated span as a
  named slice; on the card it refuses a trace without device activity,
  and without a card it refuses ``device="cuda"``.
"""

import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mc as jmc  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.config import GossipMCConfig as JConfig  # noqa: E402
from repro.core import grid as jgrid  # noqa: E402
from repro.core import state as jstate  # noqa: E402
from repro.data import lowrank_problem as j_lowrank  # noqa: E402
from repro_torch import mc as tmc  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.config import GossipMCConfig as TConfig  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.data import lowrank_problem  # noqa: E402

torch.set_num_threads(2)

M, N, R = 48, 40, 3
HP = dict(rho=1e3, lam=1e-6, a=5e-4, b=5e-7)
COST_RTOL = 1e-4


def test_span_records_both_histograms_and_syncs_outputs():
    reg = tobs.Registry()
    x = torch.arange(6.0)
    with tobs.span("unit.region", registry=reg) as sp:
        y = sp.outputs({"a": (x * 2, [x + 1]), "b": None})
    assert y["a"][0][1] == 2.0
    assert sp.seconds >= sp.host_seconds >= 0.0
    snap = reg.snapshot()["histograms"]
    assert snap["span_seconds{name=unit.region}"]["count"] == 1
    assert snap["span_host_seconds{name=unit.region}"]["count"] == 1
    with pytest.raises(ValueError):
        with tobs.span("unit.failed", registry=reg):
            raise ValueError("inside")
    assert "span_seconds{name=unit.failed}" not in \
        reg.snapshot()["histograms"]
    tree = (1, [torch.zeros(2), {"k": torch.ones(1)}], None)
    assert tobs.device_sync(tree) is tree


def _fit_both(schedule_name, **kw):
    jp = jmc.CompletionProblem.from_dataset(
        j_lowrank(M, N, R, density=0.3, seed=0), 4, 4, R, layout="sparse")
    tp = tmc.CompletionProblem.from_dataset(
        lowrank_problem(M, N, R, density=0.3, seed=0), 4, 4, R,
        layout="sparse", device="cpu")
    st = jstate.init_state(jax.random.PRNGKey(0),
                           jgrid.GridSpec(M, N, 4, 4, R))
    snaps = []
    for mod, obs_mod, cfg, prob, state in (
            (jmc, jobs, JConfig, jp, st),
            (tmc, tobs, TConfig, tp, state_from_numpy(
                *(np.asarray(x) for x in st), "cpu"))):
        obs_mod.reset()
        sched = getattr(mod, schedule_name)(**kw)
        mod.Trainer(cfg(m=M, n=N, p=4, q=4, rank=R, **HP),
                    callbacks=[mod.Telemetry()]).fit(prob, sched,
                                                     state=state)
        snaps.append(obs_mod.snapshot())
    return snaps


@pytest.mark.parametrize("schedule,kw", [
    ("FullGD", dict(num_rounds=12, eval_every=4)),
    ("Gossip", dict(num_rounds=9, eval_every=3)),
])
def test_telemetry_names_and_counts_equal_jax(schedule, kw):
    got, want = _fit_both(schedule, **kw)
    assert got["counters"] == want["counters"]
    assert set(got["gauges"]) == set(want["gauges"])
    for name in ("train_cost", "train_final_cost"):
        np.testing.assert_allclose(got["gauges"][name], want["gauges"][name],
                                   rtol=COST_RTOL)
    assert {k: v["count"] for k, v in got["histograms"].items()} == \
        {k: v["count"] for k, v in want["histograms"].items()}
    assert got["counters"]["train_units_total"] == kw["num_rounds"]
    span = "span_seconds{name=fit.%s}" % ("full" if schedule == "FullGD"
                                          else "gossip")
    assert got["histograms"][span]["count"] == 1


def test_bench_logger_rows():
    tp = tmc.CompletionProblem.from_dataset(
        lowrank_problem(M, N, R, density=0.3, seed=0), 4, 4, R,
        device="cpu")
    lines = []
    bl = tmc.BenchLogger(log=lines.append)
    res = tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R, **HP),
                      callbacks=[bl]).fit(tp, tmc.FullGD(num_rounds=6,
                                                         eval_every=2))
    assert [row[0] for row in bl.history] == [2, 4, 6]
    assert [row[2] for row in bl.history] == [c for _, c in res.history]
    assert len(lines) == 3 and "unit=" in lines[0]


def test_trace_writes_a_chrome_trace_with_the_annotated_spans(tmp_path):
    tp = tmc.CompletionProblem.from_dataset(
        lowrank_problem(M, N, R, density=0.3, seed=0), 4, 4, R,
        device="cpu")
    with tobs.trace(str(tmp_path), device="cpu"):
        with tobs.span("unit.annotated", annotate=True) as sp:
            sp.outputs(torch.ones(4) * 3)
        tmc.Trainer(TConfig(m=M, n=N, p=4, q=4, rank=R, **HP)).fit(
            tp, tmc.FullGD(num_rounds=2))
    path = os.path.join(str(tmp_path), tobs.spans.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"unit.annotated", "fit.full"} <= names


def test_trace_on_the_card_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: tests/test_torch_cuda.py "
                    "traces it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with tobs.trace(str(tmp_path)):
            pass
