"""Communication accounting through the port: the gossip halo exchange
against centralized baselines, and a measured grid fit.

The port's twin of ``benchmarks/gossip_comm.py``, with its flags, its
rows and its line format.  Per-round wire bytes *per agent* for

(a) the paper's gossip halo exchange: ≤2 U edges + ≤2 W edges to grid
    neighbours (what ``core/gossip.py``'s exchange moves),
(b) a parameter-server sync: every agent uploads its block factors and
    downloads the *global* view of its row's U and column's W,
(c) ring all-reduce consensus over each row's U and column's W
    (2·(g−1)/g · payload per member, g = row/col length),

plus the int8/top-k compressed gossip variants, from ``MeshPlan``,
``compress.message_bytes_n`` and ``halo_bytes_per_round``.  The derived
column is the time of the interior agent's bytes at one card's NVLink
rate in one direction (``roofline.HW().ici_bw``, 450 GB/s on the H100;
the JAX script's column reads 50 GB/s of TPU ICI).

``--measure`` also runs a ``Gossip`` fit through ``Trainer.fit`` on a
2 × 2 grid of ranks (``launch.gossip.run_on_grid``: ``gloo`` on one card
or the CPU, ``nccl`` with a card a rank when the machine has four) and
reports the steady-state ms a round from the callback stamps, the
consensus error and the halo bytes a round, as the JAX script's
``measured_row`` does on its forced host devices.  ::

    python -m repro_torch.launch.gossip_comm [--rank 64] [--measure] \\
        [--measure-rounds 30] [--json PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from repro_torch.config import GossipMCConfig
from repro_torch.core import compress as C
from repro_torch.core.gossip import halo_bytes_per_round
from repro_torch.core.state import resolve_device
from repro_torch.launch.bench_json import emit_json
from repro_torch.mesh import MeshPlan
from repro_torch.roofline import HW

MEASURE_GRID = (2, 2)


def bytes_per_round(plan: MeshPlan, mb: int, nb: int, r: int,
                    compression: str = "none"):
    """Per-agent wire bytes for one round, from the plan's grid geometry
    (p×q agents, each owning an mb×nb block with rank-r factors)."""

    p, q = plan.p, plan.q
    u_msg, w_msg = mb * r, nb * r
    # (a) gossip: send+receive 2 U edges and 2 W edges (interior agent)
    gossip = 2 * (C.message_bytes_n(u_msg, compression)
                  + C.message_bytes_n(w_msg, compression))
    # (b) server round-trip: upload own U,W; download the row's global U
    #     (pre-consensus the server must ship all q versions) and the
    #     column's global W
    up = (u_msg + w_msg) * 4
    down = (q * u_msg + p * w_msg) * 4
    ps = up + down
    # (c) ring all-reduce over row (q members, U) and column (p, W)
    ar = 2 * (q - 1) / q * u_msg * 4 + 2 * (p - 1) / p * w_msg * 4
    return gossip, ps, ar


def analytic_rows(r: int, hw: HW = HW()):
    """The paper-scale deployments: one agent per block, blocks over a
    matching rank grid (arithmetic only, no ranks needed)."""

    rows = []
    for (m, n, p, q) in [(1 << 20, 1 << 20, 16, 16),
                         (1 << 20, 1 << 20, 64, 64),
                         (5000, 5000, 5, 5)]:
        plan = MeshPlan.build(p, q)
        mb, nb = m // p, n // q
        for comp in ("none", "int8", "topk"):
            g, ps, ar = bytes_per_round(plan, mb, nb, r, comp)
            # exact grid-wide accounting from the edge geometry the
            # exchange runs: boundary agents send fewer edges, so the
            # total is NOT p·q × the interior-agent figure
            halo = halo_bytes_per_round(plan, mb, nb, r, comp, grid=(p, q))
            assert halo["per_interior_agent_bytes"] == g
            rows.append({
                "grid": f"{p}x{q}", "m": m, "n": n, "rank": r,
                "compression": comp,
                "gossip_bytes": g, "server_bytes": ps,
                "ring_allreduce_bytes": ar,
                "halo_total_bytes": halo["total_bytes"],
                "ici_us": g / hw.ici_bw * 1e6,
                "vs_server": g / ps, "vs_allreduce": g / ar,
            })
    return rows


class _Stamps:
    """Host clock at every eval boundary (the ``Trainer`` callback
    protocol)."""

    def __init__(self):
        self.t = []

    def on_fit_start(self, problem, schedule, cfg):
        pass

    def on_eval(self, unit, cost, state, key):
        self.t.append(time.perf_counter())

    def on_fit_end(self, result):
        pass


def _measure_rank(rank, device, rounds, grid, state):
    from repro_torch.convert import state_from_numpy
    from repro_torch.data import lowrank_problem
    from repro_torch.launch.gossip import _wrappers
    from repro_torch.mc import CompletionProblem, Gossip, Trainer

    p, q = max(2, grid[0]), max(2, grid[1])
    m = n = 64 * max(p, q)
    plan = MeshPlan.build(p, q, grid=grid)
    ds = lowrank_problem(m, n, r=4, density=0.2, seed=0)
    problem = CompletionProblem.from_dataset(ds, p, q, 4, layout="sparse",
                                             plan=plan, device=device)
    cfg = GossipMCConfig(m=m, n=n, p=p, q=q, rank=4)
    st0 = None if state is None else state_from_numpy(*state, device)

    # steady-state timing: one fit, eval boundaries every `rounds`
    # rounds, stamped by the callback; the first chunk pays one-time
    # costs, so only the later intervals (rounds + one cost eval) count
    chunks = 4
    stamps = _Stamps()
    before = {k: fn.launches for k, fn in _wrappers().items()}
    res = Trainer(cfg, callbacks=[stamps]).fit(
        problem, Gossip(num_rounds=chunks * rounds, eval_every=rounds,
                        plan=plan), seed=0, state=st0)
    launches = {k: fn.launches - before[k] for k, fn in _wrappers().items()}
    if rank != 0:
        return {"launches": launches}
    steady = [b - a for a, b in zip(stamps.t[1:-1], stamps.t[2:])]
    mb, nb = m // p, n // q
    g, ps, ar = bytes_per_round(plan, mb, nb, 4)
    # what the fit moved: exact wire bytes a round from the rank grid's
    # edge geometry (the figure Gossip streams into
    # train_gossip_halo_bytes_total)
    halo = halo_bytes_per_round(plan, mb, nb, 4)
    cu, cw = res.consensus_error()
    return {
        "grid": f"{p}x{q}", "m": m, "n": n, "rank": 4,
        "devices": plan.num_devices, "rounds": rounds,
        "ms_per_round": min(steady) / rounds * 1e3,
        "final_cost": res.final_cost,
        "consensus_error": max(float(cu), float(cw)),
        "halo": halo,
        "gossip_bytes": g, "server_bytes": ps,
        "ring_allreduce_bytes": ar, "vs_server": g / ps,
        "launches": launches,
    }


def measured_row(rounds: int, device="cuda", state=None) -> dict:
    """A small ``Gossip`` fit through the facade on the 2 × 2 grid of
    ranks (rank 0's row, with the f-gradient kernels' ``launches`` summed over
    the ranks).  ``state`` is an optional global initial ``(U, W, t)`` of
    numpy arrays (default: every rank draws it from seed 0)."""

    from repro_torch.launch.gossip import pick_backend, run_on_grid

    device = resolve_device(device)
    ranks = run_on_grid(_measure_rank, MEASURE_GRID, rounds, MEASURE_GRID,
                        state, device=device.type, timeout=600.0)
    out = ranks[0]
    out["backend"] = pick_backend(device.type, len(ranks))
    # the f-gradient kernels' launches, summed over the ranks
    out["launches"] = {k: sum(r["launches"][k] for r in ranks)
                       for k in out["launches"]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--measure", action="store_true",
                    help="also run a small Gossip fit on a 2x2 grid of "
                         "ranks and report ms/round")
    ap.add_argument("--measure-rounds", type=int, default=30)
    ap.add_argument("--json", type=str, default=None,
                    help="write results as JSON to this path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows = analytic_rows(args.rank)
    for r_ in rows:
        print(f"gossip_comm_{r_['grid']}_{r_['compression']},"
              f"{r_['ici_us']:.2f},"
              f"gossip_B={r_['gossip_bytes']:.3g};"
              f"server_B={r_['server_bytes']:.3g};"
              f"ring_allreduce_B={r_['ring_allreduce_bytes']:.3g};"
              f"vs_server={r_['vs_server']:.4f};"
              f"vs_allreduce={r_['vs_allreduce']:.3f}")

    measured = None
    if args.measure:
        from repro_torch.launch.gossip import shutdown

        try:
            measured = measured_row(args.measure_rounds, device)
        finally:
            shutdown()
        print(f"measured {measured['grid']} grid on {measured['devices']} "
              f"rank(s) ({measured['backend']}, {device.type}): "
              f"{measured['ms_per_round']:.2f} ms/round "
              f"({measured['rounds']} rounds, cost "
              f"{measured['final_cost']:.3e}, consensus "
              f"{measured['consensus_error']:.3e}, "
              f"{measured['halo']['total_bytes']} halo B/round)")

    payload = {"rows": rows}
    if measured is not None:
        payload["measured"] = measured
    if args.json:
        emit_json(args.json, "gossip_comm",
                  {"rank": args.rank, "ici_gbps": HW().ici_bw / 1e9,
                   "measure": bool(args.measure)}, device, **payload)
    return payload


if __name__ == "__main__":
    main()
