"""Every float32 contraction on the main path runs at HIGHEST precision.

On a GPU a float32 ``dot_general`` at DEFAULT precision may run in TF32,
which keeps ~3 decimal digits: millimetres of error on a 3 m world
coordinate, against 2 cm voxels and a 1 cm Huber band
(geometry/se3.matmul).  These tests walk the jaxprs of the jitted entry
points and fail on any float32 ``dot_general`` left at DEFAULT.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voxelhashing_demo_tpu.config import (KeyframeConfig, RaycastConfig,
                                          tiny_config)
from voxelhashing_demo_tpu.geometry import procrustes, se3
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.ops import pose_graph

_HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _f32_dots(jaxpr):
    """(eqn) of every float32 dot_general in ``jaxpr``, nested included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            yield eqn
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _f32_dots(sub)


def _loose(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    dots = list(_f32_dots(jaxpr))
    assert dots, "expected float32 contractions in the traced program"
    return [
        str(e) for e in dots
        if e.params["precision"] is None
        or any(p != _HIGHEST for p in e.params["precision"])
    ]


def _step_case(config):
    state = hash_slam.create(config)
    depth = jnp.full((config.camera.height, config.camera.width), 7500,
                     jnp.uint16)
    return (lambda s, d: hash_slam.step(s, d, config)), (state, depth)


def _graph_case(solver):
    cfg = KeyframeConfig(ba_solver=solver, ba_iters=2)
    g = pose_graph.create(4, 8)
    for k in range(3):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * k
        g = pose_graph.add_pose(g, jnp.asarray(T))
    g = pose_graph.add_edge(g, 0, 1, se3.exp(jnp.full((6,), 0.01)))
    g = pose_graph.add_edge(g, 1, 2, se3.exp(jnp.full((6,), 0.02)))
    return (lambda gr: pose_graph.optimize(gr, cfg)), (g,)


def _procrustes_case():
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32))
    return procrustes.procrustes, (src, src + 0.1)


CASES = {
    "hash_slam_step": lambda: _step_case(tiny_config()),
    "hash_slam_step_pyramid_robust": lambda: _step_case(dataclasses.replace(
        tiny_config(),
        icp=dataclasses.replace(tiny_config().icp, pyramid=(4, 2, 1),
                                pyramid_iters=(3, 2, 1), huber_delta=0.01),
    )),
    "hash_slam_step_march": lambda: _step_case(dataclasses.replace(
        tiny_config(),
        raycast=RaycastConfig(mode="march", max_steps=8,
                              cache_dims=(32, 32, 32)),
    )),
    "pose_graph_dense": lambda: _graph_case("dense"),
    "pose_graph_cg": lambda: _graph_case("cg"),
    "procrustes": _procrustes_case,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_default_precision_f32_dot(name):
    fn, args = CASES[name]()
    assert _loose(fn, *args) == []


def test_walker_sees_default_precision():
    """The check itself: a bare ``@`` is reported."""
    a = jnp.ones((3, 3), jnp.float32)
    assert len(_loose(lambda x: x @ x, a)) == 1
    assert _loose(se3.matmul, a, a) == []
