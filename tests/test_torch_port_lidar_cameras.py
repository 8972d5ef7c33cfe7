"""The port's DLA, VoVNet and DepthLSSTransform against the JAX package's,
on the CPU (the cases and checks: ``tests/torch_port_lidar_cases.py``; a
file of their own, so that their JAX compiles run beside the other lidar
pieces' on another worker).

  - ``DLA`` (DLA-34's layout at tiny widths, with a 2-level tree whose
    discarded projection moves BatchNorm statistics), ``VoVNet`` (two OSA
    stages, the second with an identity block) and ``DepthLSSTransform`` on
    the synthetic rig with a depth canvas of random points: eval outputs in
    float32, and one float64 training step's outputs, batch statistics and
    gradients.
"""
import pytest

from torch_port_lidar_cases import GROUPS, check_eval, check_train
from torch_port_threads import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", GROUPS["cameras"])
def test_eval_matches_jax(name):
    check_eval(name)


@pytest.mark.parametrize("name", GROUPS["cameras"])
def test_train_step_matches_jax_float64(name):
    check_train(name)
