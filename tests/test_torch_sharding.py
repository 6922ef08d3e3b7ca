"""The port's sharding rules (``repro_torch.sharding.specs``) against the
JAX package's.

The four cases of tests/test_sharding_properties.py run on the port's
mesh description, the hypothesis property included.  Then every leaf of
``lm_schema``, of ``opt_state_schema`` under every recipe (f32, bf16 or
int8 moments, full or factored v) and of ``cache_schema`` gets the same
spec entries from the port's ``spec_for`` as from JAX's, for every arch,
under the arch's ``ParallelConfig``, its pure-FSDP variant and the
default one, on both production meshes: exact equality.  JAX's specs are
computed on a ``Mesh`` over repeated host devices, as the reference's own
test builds one; only the spec arithmetic reads it.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis",
                    reason="optional dev dependency (requirements-dev.txt)")
from hypothesis import given, settings, strategies as st      # noqa: E402
from jax.sharding import Mesh as JMesh                          # noqa: E402

from repro.configs import registry as jreg                      # noqa: E402
from repro.configs.base import OptimizerConfig as JOpt          # noqa: E402
from repro.configs.base import ParallelConfig as JPar           # noqa: E402
from repro.models import params as jpr                          # noqa: E402
from repro.optim import adamw as jadamw                         # noqa: E402
from repro.runtime import steps as jsteps                       # noqa: E402
from repro.sharding import specs as jsh                         # noqa: E402

from repro_torch.configs import registry as treg               # noqa: E402
from repro_torch.configs.base import SHAPES                     # noqa: E402
from repro_torch.configs.base import OptimizerConfig             # noqa: E402
from repro_torch.configs.base import ParallelConfig              # noqa: E402
from repro_torch.launch import mesh as tmesh                    # noqa: E402
from repro_torch.models import params as tpr                    # noqa: E402
from repro_torch.models.params import PSpec                     # noqa: E402
from repro_torch.optim import adamw as tadamw                   # noqa: E402
from repro_torch.runtime import steps as tsteps                 # noqa: E402
from repro_torch.sharding import specs as sh                    # noqa: E402

RULES = sh.logical_rules(ParallelConfig())
LOGICAL = list(RULES.keys())
MESH = tmesh.make_mesh((4, 2), ("data", "model"))
RECIPES = [(m, s) for m in ("float32", "bfloat16", "int8")
           for s in ("full", "factored")]


def fake_mesh(shape, axes):
    """A JAX mesh over repeated host devices: enough for specs."""
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices() * n)[:n].reshape(shape), axes)


@settings(max_examples=200, deadline=None)
@given(dims=st.lists(st.integers(min_value=1, max_value=64), min_size=1,
                     max_size=4),
       names=st.lists(st.sampled_from(LOGICAL + [None]), min_size=1,
                      max_size=4))
def test_spec_divisibility_and_axis_uniqueness(dims, names):
    n = min(len(dims), len(names))
    dims, names = tuple(dims[:n]), tuple(names[:n])
    spec = sh.spec_for(dims, names, MESH, RULES)
    used = []
    for dim, entry in zip(dims, spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        for a in axes:
            assert a in MESH.shape
            used.append(a)
        size = int(np.prod([MESH.shape[a] for a in axes]))
        assert dim % size == 0, (dims, names, spec)
    assert len(used) == len(set(used)), f"mesh axis reused: {spec}"
    # and the shard shape divides each dim by its axes' size
    block = sh.shard_shape(dims, spec, MESH)
    assert all(d * sh._mesh_size(MESH, e) == g
               for d, e, g in zip(block, spec, dims))


def test_pod_axis_dropped_on_single_pod_mesh():
    spec = sh.spec_for((8, 4), ("batch", None), MESH, RULES)
    # "batch" -> ("pod","data"); pod absent -> only data
    assert spec[0] == "data"


def test_non_divisible_falls_back_to_replication():
    spec = sh.spec_for((3, 5), ("batch", "tp_ff"), MESH, RULES)
    assert spec[0] is None and spec[1] is None


def test_shardings_for_schema_tree():
    """The dry run's walk over a schema's meta tree gives each leaf its
    spec (the reference's ``shardings_for_schema`` tree, leaf by leaf)."""
    from repro_torch.launch import dryrun
    schema = {"w": PSpec((8, 4), ("fsdp", "tp_ff")),
              "b": {"x": PSpec((6,), (None,))}}
    metas = tpr.abstract_params(schema, "float32")
    tree = {path: sh.spec_for(t.shape, ax, MESH, RULES)
            for path, t, ax in dryrun.leaves(metas, tpr.axes_tree(schema))}
    assert tree == {"w": ("data", "model"), "b/x": (None,)}
    assert sh.shard_shape((8, 4), tree["w"], MESH) == (2, 2)
    assert dryrun.shard_bytes(metas, tpr.axes_tree(schema), MESH,
                              RULES) == (2 * 2 + 6) * 4


def test_logical_rules_equal_the_reference():
    for kw in ({}, {"pure_fsdp": True}, {"tensor_parallel": False},
               {"fsdp": False, "expert_parallel": False},
               {"sequence_parallel": False, "context_parallel_decode": False},
               {"pure_fsdp": True, "context_parallel_decode": False}):
        assert sh.logical_rules(ParallelConfig(**kw)) == \
            jsh.logical_rules(JPar(**kw)), kw


def test_meshes_are_the_reference_layouts():
    from repro.launch import mesh as jmesh
    assert tmesh.PRODUCTION_MESH_SHAPE == jmesh.PRODUCTION_MESH_SHAPE
    assert tmesh.PRODUCTION_MESH_SHAPE_MULTI_POD == \
        jmesh.PRODUCTION_MESH_SHAPE_MULTI_POD
    one, two = (tmesh.make_production_mesh(multi_pod=m) for m in (False, True))
    assert one.shape == {"data": 16, "model": 16} and one.tag == "16x16"
    assert list(two.shape.items()) == [("pod", 2), ("data", 16),
                                       ("model", 16)]
    assert (tmesh.mesh_num_chips(one), tmesh.mesh_num_chips(two)) == (256,
                                                                      512)
    single = tmesh.single_device_mesh()
    assert single.shape == {"data": 1, "model": 1}
    assert tmesh.mesh_num_chips(single) == 1
    # on one card every spec is whole
    w = tpr.abstract_params({"w": PSpec((8, 4), ("fsdp", "tp_ff"))},
                            "float32")["w"]
    spec = sh.spec_for(w.shape, ("fsdp", "tp_ff"), single, RULES)
    assert sh.shard_shape(w.shape, spec, single) == (8, 4)
    with pytest.raises(ValueError):
        tmesh.make_mesh((2, 2), ("data", "data"))


def _schemas(arch):
    """(name, JAX schema, port schema) of every tree a step shards."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    shape = SHAPES["decode_32k"]
    jcfg, tcfg = jsteps.resolve_cfg(jcfg, shape), tsteps.resolve_cfg(tcfg,
                                                                     shape)
    jmod, tmod = jsteps._model_module(jcfg), tsteps._model_module(tcfg)
    js, ts = jmod.lm_schema(jcfg), tmod.lm_schema(tcfg)
    out = [("lm", js, ts),
           ("cache", jmod.cache_schema(jcfg, 128, 32_768),
            tmod.cache_schema(tcfg, 128, 32_768))]
    for m, v in RECIPES:
        out.append((f"opt {m}/{v}",
                    jadamw.opt_state_schema(js, JOpt(moment_dtype=m,
                                                      second_moment=v)),
                    tadamw.opt_state_schema(ts, OptimizerConfig(
                        moment_dtype=m, second_moment=v))))
    return out


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_specs_equal_jax_on_every_leaf(arch):
    """Every leaf's spec, the port's against JAX's spec_for."""
    schemas = _schemas(arch)
    meshes = [(tmesh.make_production_mesh(multi_pod=mp),
               fake_mesh(jshape, axes))
              for mp, jshape, axes in (
                  (False, (16, 16), ("data", "model")),
                  (True, (2, 16, 16), ("pod", "data", "model")))]
    own = treg.get_parallel(arch)
    pars = {"arch": own, "pure_fsdp": dataclasses.replace(own,
                                                           pure_fsdp=True),
            "default": ParallelConfig()}
    n = 0
    for pname, par in pars.items():
        jpar = JPar(**dataclasses.asdict(par))
        trules, jrules = sh.logical_rules(par), jsh.logical_rules(jpar)
        for tm, jm in meshes:
            for name, js, ts in schemas:
                want = dict(jpr._leaves(js))
                got = dict(tpr.leaves(ts))
                assert sorted(want) == sorted(got), name
                for path, jp in want.items():
                    tp = got[path]
                    assert (tp.shape, tp.axes) == (jp.shape, jp.axes)
                    w = tuple(jsh.spec_for(jp.shape, jp.axes, jm, jrules))
                    g = sh.spec_for(tp.shape, tp.axes, tm, trules)
                    assert g == w, (pname, tm.tag, name, path, g, w)
                    n += 1
    assert n > 0
