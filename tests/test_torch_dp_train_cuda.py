"""The sharded train step on one card shared by four ``gloo`` ranks (the
port's CUDA path; skipped without a card).  It imports nothing of the
JAX package, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dp_train_cuda.py

gemma2-2b's smoke config, 8 x 32 tokens a step as microbatch=2, AdamW at
lr 1e-3 (``TrainConfig``'s clip on), two steps: one process against four
ranks at ``(data 4)`` and at ``(pod 2, data 2)`` from the same seeded
init (``init_shard``).  The ranks' FSDP gathers copy the peers' shards
device to device (CUDA IPC); step 2 reads the shards step 1 updated in
place, so a read before a peer's update has landed would show in step
2's loss and in the parameters.  Held: both losses at rel 1e-5, every
rank's shards after two steps by ``tests/test_torch_train.py``'s AdamW
rule (``ADAM_MAX`` x lr, ``ADAM_FRAC`` of coordinates beyond 1e-3 lr).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import (  # noqa: E402
    MeshConfig,
    ShapeConfig,
    TrainConfig,
    get_smoke_config,
)
from repro_torch.data import LMTokenPipeline  # noqa: E402
from repro_torch.launch.gossip import run_on_grid  # noqa: E402
from repro_torch.models import Ctx, build_model  # noqa: E402
from repro_torch.models.api import param_specs  # noqa: E402
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402
from repro_torch.train.shard import init_shard, shard_leaf  # noqa: E402
from repro_torch.train.step import make_sharded_train_step  # noqa: E402

pytestmark = pytest.mark.cuda

B, SEQ, MICRO, LR, SEED = 8, 32, 2, 1e-3, 0
LOSS_RTOL, ADAM_MAX, ADAM_FRAC = 1e-5, 0.25, 1e-3
MESHES = {"data4": dict(pod=1, data=4, model=1, fsdp=True),
          "pods2x2": dict(multi_pod=True, pod=2, data=2, model=1,
                          fsdp=True)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ranks share one card")
    return torch.device("cuda")


def _train(cfg, mesh_cfg, group, rank, device, data):
    model = build_model(cfg, Ctx(attn_impl="ref", remat=True), device=device)
    step, info = make_sharded_train_step(
        model, group, mesh_cfg, ShapeConfig("t", SEQ, B, "train"),
        TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10,
                    microbatch=MICRO))
    params = init_shard(SEED, cfg, None, mesh_cfg, rank, device)
    state = info["optimizer"].init(params)
    losses = []
    for batch in data:
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return losses, params, info


def _rank(rank, device, cfg, data):
    import torch.distributed as dist

    out = {}
    for name, mesh_kw in MESHES.items():
        losses, params, info = _train(cfg, MeshConfig(**mesh_kw),
                                      dist.group.WORLD, rank, device, data)
        shards = {}
        tree_map_with_path(lambda p, x: shards.__setitem__(
            p, x.cpu().numpy()), params)
        fsdp = info["grid"].fsdp
        out[name] = {"losses": losses, "shards": shards,
                     "peer_reads": bool(fsdp.one_card and fsdp.peers)}
    return out


def test_dp_train_on_one_card_reads_the_updated_peer_shards(cuda):
    cfg = get_smoke_config("gemma2-2b")
    pipe = LMTokenPipeline(cfg.vocab_size, SEQ, B)
    data = [dict(zip(("tokens", "targets"), pipe.batch_at(i)))
            for i in range(2)]
    one = MeshConfig(data=1, model=1, fsdp=True)
    want, params, _ = _train(cfg, one, None, 0, cuda, data)
    ranks = run_on_grid(_rank, (4, 1), cfg, data, device="cuda",
                        timeout=300)
    shapes = param_specs(build_model(cfg, device="meta"))
    for name, mesh_kw in MESHES.items():
        mesh_cfg = MeshConfig(**mesh_kw)
        pspecs = S.param_pspecs(cfg, shapes, mesh_cfg)
        diffs = []
        for r, res in enumerate(ranks):
            got = res[name]
            np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL,
                                       err_msg=f"{name} rank {r}")
            if torch.cuda.device_count() < 4:
                assert got["peer_reads"], name

            def hold(path, x, spec):
                ref = shard_leaf(x, spec, mesh_cfg, r).cpu().numpy()
                diffs.append(np.abs(got["shards"][path] - ref).ravel())

            tree_map_with_path(hold, params, pspecs)
        d = np.concatenate(diffs)
        assert float(d.max()) <= ADAM_MAX * LR, name
        assert float(np.mean(d > 1e-3 * LR)) <= ADAM_FRAC, name
