"""The port's sharding rules, shapes and parameter counts against the JAX
package's, exactly.

For every arch of ``ARCHS`` at its full-size config (shapes only: the
JAX side from ``jax.eval_shape``, the port's from ``init`` and
``init_cache`` on the ``meta`` device), leaf by leaf and keyed by path:
``param_pspecs`` under the JAX tests' mesh (data 16 x model 16, FSDP),
the multi-pod mesh and a 1 x 4 serving grid; ``cache_pspecs_tree`` and
``batch_pspecs`` at ``decode_32k``, ``long_500k`` and a B = 4 decode
shape; the ``param_specs``/``cache_specs``/``input_specs`` shapes and
the three parameter counts.  Specs are metadata, so nothing is held to a
tolerance.
"""

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.config import MeshConfig as JMesh  # noqa: E402
from repro.config import get_model_config as j_get  # noqa: E402
from repro.config import get_shape as j_shape  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import sharding as JS  # noqa: E402
from repro_torch.config import ARCHS, MeshConfig, ShapeConfig  # noqa: E402
from repro_torch.config import get_model_config, get_shape  # noqa: E402
from repro_torch.mesh import plan as mesh_plan  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim.optimizers import tree_map_with_path  # noqa: E402
from repro_torch.train import sharding as S  # noqa: E402

MESHES = {
    "data16_model16_fsdp": dict(multi_pod=False, pod=1, data=16, model=16,
                                fsdp=True),
    "multi_pod": dict(multi_pod=True, pod=2, data=16, model=16),
    "data1_model4": dict(data=1, model=4, fsdp=False),
}
SHAPES = ("decode_32k", "long_500k", "decode_b4")


def _jshape(name):
    from repro.config import ShapeConfig as JShape
    if name == "decode_b4":
        return JShape("decode_b4", 2048, 4, "decode")
    return j_shape(name)


def _tshape(name):
    if name == "decode_b4":
        return ShapeConfig("decode_b4", 2048, 4, "decode")
    return get_shape(name)


def _jflat(shapes, specs=None):
    """{keystr path: (shape, spec entries)} of a JAX tree."""

    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = (jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        if specs is not None else [None] * len(leaves))
    return {jax.tree_util.keystr(p): (tuple(x.shape),
                                      None if s is None else tuple(s))
            for (p, x), s in zip(leaves, spec_leaves)}


def _tflat(shapes, specs=None):
    out = {}

    def visit(path, leaf, *spec):
        out[path] = (tuple(leaf.shape), tuple(spec[0]) if spec else None)

    tree_map_with_path(visit, shapes, *([specs] if specs is not None
                                        else []))
    return out


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = j_build(j_get(arch))
        tm = api.build_model(get_model_config(arch), device="meta")
        out[arch] = (jm, tm, JA.param_specs(jm), api.param_specs(tm))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_jax(models, arch, mesh):
    jm, tm, jshapes, tshapes = models[arch]
    want = _jflat(jshapes, JS.param_pspecs(jm.cfg, jshapes,
                                           JMesh(**MESHES[mesh])))
    got = _tflat(tshapes, S.param_pspecs(tm.cfg, tshapes,
                                         MeshConfig(**MESHES[mesh])))
    assert got == want
    assert all(isinstance(s, tuple) for _, s in got.values())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_pspecs_equal_jax(models, arch, shape):
    jm, tm, _, _ = models[arch]
    js, ts = _jshape(shape), _tshape(shape)
    extra = jm.cfg.num_patch_tokens if jm.cfg.family == "vlm" else 0
    jc = JA.cache_specs(jm, js.global_batch, js.seq_len + extra)
    tc = api.cache_specs(tm, ts.global_batch, ts.seq_len + extra)
    jb, tb = JA.input_specs(jm.cfg, js), api.input_specs(tm.cfg, ts)
    assert _tflat(tb) == _jflat(jb)
    assert {k: str(v.dtype).split(".")[-1] for k, v in tb.items()} == {
        k: str(v.dtype) for k, v in jb.items()}
    for mesh in MESHES.values():
        jmesh, tmesh = JMesh(**mesh), MeshConfig(**mesh)
        assert _tflat(tc, S.cache_pspecs_tree(tm.cfg, ts, tmesh, tc)) == \
            _jflat(jc, JS.cache_pspecs_tree(jm.cfg, js, jmesh, jc))
        assert _tflat(tb, S.batch_pspecs(tm.cfg, ts, tmesh, tb)) == \
            _jflat(jb, JS.batch_pspecs(jm.cfg, js, jmesh, jb))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_shapes_and_counts_equal_jax(models, arch):
    jm, tm, jshapes, tshapes = models[arch]
    assert _tflat(tshapes) == _jflat(jshapes)
    assert {p: x.dtype for p, x in _leaves(tshapes)} == {
        p: getattr(torch, str(x.dtype)) for p, x in _leaves(jshapes, True)}
    cfg = tm.cfg
    assert api.param_count(cfg) == JA.param_count(jm.cfg)
    assert api.matmul_param_count(cfg) == JA.matmul_param_count(jm.cfg)
    assert api.active_param_count(cfg) == JA.active_param_count(jm.cfg)
    # meta tensors: no storage was allocated
    assert all(x.device.type == "meta" for _, x in _leaves(tshapes))


def _leaves(tree, jax_tree=False):
    if jax_tree:
        return [(jax.tree_util.keystr(p), x) for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]]
    out = []
    tree_map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def test_axis_helpers_equal_jax():
    from repro.mesh import plan as jplan
    for dim in (0, 1, 7, 16, 40, 128):
        for by in (0, 1, 2, 4, 16):
            assert mesh_plan.divides(dim, by) == jplan.divides(dim, by)
            assert mesh_plan.axis_if_divisible(dim, "model", by) == \
                jplan.axis_if_divisible(dim, "model", by)
    for mesh in MESHES.values():
        assert mesh_plan.dp_axes(MeshConfig(**mesh)) == \
            jplan.dp_axes(JMesh(**mesh))
    assert MeshConfig() == MeshConfig(multi_pod=False, pod=1, data=16,
                                      model=16, fsdp=True)
    assert MeshConfig(**MESHES["multi_pod"]).num_devices == \
        JMesh(**MESHES["multi_pod"]).num_devices == 512


def test_spec_type_and_leaf_names():
    assert tuple(S.P(None, "data", "model")) == tuple(
        jax.sharding.PartitionSpec(None, "data", "model"))
    for entries in ([("data",), None], [("pod", "data")], [()], [["a"]]):
        assert tuple(S.P(*entries)) == tuple(
            jax.sharding.PartitionSpec(*entries))
    assert S.leaf_name("['units']['s0']['attn']['wq']") == "wq"
    assert S.leaf_name("['units']['s0'].k") == "k"
    assert S.leaf_name("['a'][0]") == "a"
    assert S.leaf_name("") == ""
