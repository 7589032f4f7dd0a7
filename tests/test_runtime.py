"""Entry-point runtime rules, the YAML-subset config parser, the kernel
wrapper's block shapes, and the XLA engine's matmul precision."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from ilqr_tpu import runtime
from ilqr_tpu.config import parse_yaml
from tests.conftest import CONFIG_DIR

REPO = os.path.join(os.path.dirname(__file__), "..")


def test_compile_cache_dir_rule():
    """JAX_COMPILATION_CACHE_DIR wins (JAX reads it itself, so nothing is
    set); otherwise the fixed .jax_cache at the checkout root."""
    assert runtime.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None
    path = runtime.compile_cache_dir({})
    assert path == os.path.join(os.path.abspath(REPO), ".jax_cache")


@pytest.mark.parametrize("platform,engine", [("gpu", "kernel"),
                                             ("cpu", "xla")])
def test_engine_choice_per_backend(platform, engine):
    assert runtime.engine_for(platform) == engine


def test_entry_point_without_gpu_fails():
    """No GPU and no explicit CPU request: the entry point exits non-zero
    before any work instead of falling back to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run(
        [sys.executable, "-m", "ilqr_tpu.apps.sweep", "-c",
         os.path.join(CONFIG_DIR, "scenario_two_straight.yaml"),
         "--steps", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr


def test_entry_point_with_explicit_cpu_says_cpu():
    assert runtime.cpu_requested()
    assert runtime.platform() == "cpu"


def test_xla_engine_dots_are_highest_precision():
    """Every dot in the XLA engine's solve carries HIGHEST precision, so f32
    stays f32 on a GPU rather than TF32."""
    from ilqr_tpu.config import GlobalConfig
    from ilqr_tpu.sim.scenario import build_scenario_setup
    from ilqr_tpu.solvers.cilqr import solve
    from ilqr_tpu.types import CILQRConfig, CILQRWeights

    gc = GlobalConfig.from_file(os.path.join(CONFIG_DIR,
                                             "scenario_two_straight.yaml"))
    st = build_scenario_setup(gc)
    cfg = CILQRConfig.from_global_config(gc, max_iter=2)
    w = CILQRWeights.from_global_config(gc, dtype=jnp.float32)
    scen = st.device_scenario(tick=0, dtype=jnp.float32)
    x0 = jnp.asarray(st.ego_x0, jnp.float32)
    jaxpr = jax.make_jaxpr(lambda x: solve(cfg, w, x, scen))(x0)

    dots = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                dots.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    assert dots, "the solve has no dots to check"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in dots), set(map(str, dots))


# the four scenario files as literal dicts
_LITERAL = {'scenario_two_straight': {'delta_t': 0.1,
                           'max_simulation_time': 12,
                           'vehicle': {'reference_point': 'rear_center',
                                       'target_velocity': 8,
                                       'wheelbase': 2.8,
                                       'width': 2,
                                       'length': 4.5,
                                       'velo_max': 15.0,
                                       'velo_min': 0.0,
                                       'yaw_lim': 1.57,
                                       'acc_max': 3.0,
                                       'acc_min': -3.0,
                                       'stl_lim': 0.12,
                                       'd_safe': 1.0},
                           'lqr': {'N': 30,
                                   'nx': 4,
                                   'nu': 2,
                                   'w_pos': 1.0,
                                   'w_vel': 1.0,
                                   'w_yaw': 20.0,
                                   'w_acc': 0.5,
                                   'w_stl': 20.0,
                                   'slove_type': 'barrier',
                                   'alm_rho_init': 20,
                                   'alm_gamma': 0,
                                   'max_rho': 20,
                                   'max_mu': 120,
                                   'obstacle_exp_q1': 5.5,
                                   'obstacle_exp_q2': 5.75,
                                   'state_exp_q1': 3.0,
                                   'state_exp_q2': 3.5,
                                   'use_last_solution': False},
                           'iteration': {'max_iter': 100,
                                         'init_lamb': 0,
                                         'lamb_decay': 0.5,
                                         'lamb_amplify': 2.0,
                                         'max_lamb': 1000.0,
                                         'convergence_threshold': 0.01,
                                         'accept_step_threshold': 0.5},
                           'laneline': {'reference': {'x': [-10,
                                                            0,
                                                            50,
                                                            100,
                                                            150,
                                                            200],
                                                      'y': [0,
                                                            0,
                                                            0,
                                                            0,
                                                            0,
                                                            0]},
                                        'border': [-1.8, 1.8, 5.4],
                                        'center_line': [0, 3.6]},
                           'initial_condition': [[0, 0, 8.0, 0],
                                                 [30, 0, 3.0, 0],
                                                 [35, 3.6, 5, 0],
                                                 [15, 3.6, 2.5, 0]],
                           'visualization': {'y_lim': [-5, 13],
                                             'show_obstacle_boundary': True}},
 'scenario_two_borrow': {'delta_t': 0.1,
                         'max_simulation_time': 15,
                         'vehicle': {'reference_point': 'gravity_center',
                                     'target_velocity': 8,
                                     'wheelbase': 2.8,
                                     'width': 2,
                                     'length': 4.5,
                                     'velo_max': 15.0,
                                     'velo_min': 0.0,
                                     'yaw_lim': 1.57,
                                     'acc_max': 3.0,
                                     'acc_min': -3.0,
                                     'stl_lim': 0.12,
                                     'd_safe': 0.9},
                         'lqr': {'N': 30,
                                 'nx': 4,
                                 'nu': 2,
                                 'w_pos': 1.0,
                                 'w_vel': 1.0,
                                 'w_yaw': 20.0,
                                 'w_acc': 0.5,
                                 'w_stl': 50.0,
                                 'slove_type': 'barrier',
                                 'alm_rho_init': 20,
                                 'alm_gamma': 0,
                                 'max_rho': 20,
                                 'max_mu': 120,
                                 'obstacle_exp_q1': 5.5,
                                 'obstacle_exp_q2': 5.75,
                                 'state_exp_q1': 3.0,
                                 'state_exp_q2': 3.5,
                                 'use_last_solution': False},
                         'iteration': {'max_iter': 100,
                                       'init_lamb': 0,
                                       'lamb_decay': 0.5,
                                       'lamb_amplify': 2.0,
                                       'max_lamb': 1000.0,
                                       'convergence_threshold': 0.01,
                                       'accept_step_threshold': 0.5},
                         'laneline': {'reference': {'x': [-10,
                                                          0,
                                                          50,
                                                          100,
                                                          150,
                                                          200],
                                                    'y': [0,
                                                          0,
                                                          0,
                                                          0,
                                                          0,
                                                          0]},
                                      'border': [-1.8, 1.8, 5.4],
                                      'center_line': [0, 3.6]},
                         'initial_condition': [[0, 0, 8.0, 0],
                                               [20, 0, 3.0, 0],
                                               [30, 0, 6.5, 0],
                                               [35, 3.6, 8.0, 3.1416],
                                               [110, 3.6, 3.0, 3.1416]],
                         'visualization': {'y_lim': [-5, 13],
                                           'show_obstacle_boundary': True}},
 'scenario_three_straight': {'delta_t': 0.1,
                             'max_simulation_time': 10,
                             'vehicle': {'target_velocity': 9,
                                         'wheelbase': 2.8,
                                         'width': 2,
                                         'length': 4.5,
                                         'velo_max': 10.0,
                                         'velo_min': 0.0,
                                         'yaw_lim': 1.57,
                                         'acc_max': 3.0,
                                         'acc_min': -3.0,
                                         'stl_lim': 0.12,
                                         'd_safe': 0.9},
                             'lqr': {'N': 30,
                                     'nx': 4,
                                     'nu': 2,
                                     'w_pos': 1.0,
                                     'w_vel': 1.0,
                                     'w_yaw': 20.0,
                                     'w_acc': 0.5,
                                     'w_stl': 30.0,
                                     'slove_type': 'barrier',
                                     'alm_rho_init': 0,
                                     'alm_gamma': 0,
                                     'max_rho': 20,
                                     'max_mu': 100,
                                     'obstacle_exp_q1': 5.5,
                                     'obstacle_exp_q2': 5.75,
                                     'state_exp_q1': 3.0,
                                     'state_exp_q2': 3.6,
                                     'use_last_solution': True},
                             'iteration': {'max_iter': 100,
                                           'init_lamb': 0,
                                           'lamb_decay': 0.5,
                                           'lamb_amplify': 2.0,
                                           'max_lamb': 1000.0,
                                           'convergence_threshold': 0.01,
                                           'accept_step_threshold': 0.5},
                             'laneline': {'reference': {'x': [-10,
                                                              0,
                                                              50,
                                                              100,
                                                              150,
                                                              200],
                                                        'y': [7.2,
                                                              7.2,
                                                              7.2,
                                                              7.2,
                                                              7.2,
                                                              7.2]},
                                          'border': [-9, -5.4, -1.8, 1.8],
                                          'center_line': [0, -3.6, -7.2]},
                             'initial_condition': [[0, 0, 6.0, 0],
                                                   [20, 0, 3.0, 0],
                                                   [40, 0, 3.0, 0],
                                                   [50, 0, 3.0, 0],
                                                   [0, 3.6, 5.0, 0],
                                                   [35, 3.6, 5.0, 0],
                                                   [50, 3.6, 5.0, 0],
                                                   [5, 7.2, 7, 0],
                                                   [50, 7.2, 6.0, 0]],
                             'visualization': {'y_lim': [-3, 17],
                                               'show_obstacle_boundary': False}},
 'scenario_three_bend': {'delta_t': 0.1,
                         'max_simulation_time': 15,
                         'vehicle': {'target_velocity': 8,
                                     'wheelbase': 2.8,
                                     'width': 2,
                                     'length': 4.5,
                                     'velo_max': 10.0,
                                     'velo_min': 0.0,
                                     'yaw_lim': 1.57,
                                     'acc_max': 3.0,
                                     'acc_min': -3.0,
                                     'stl_lim': 0.2,
                                     'd_safe': 0.8},
                         'lqr': {'N': 30,
                                 'nx': 4,
                                 'nu': 2,
                                 'w_pos': 1.0,
                                 'w_vel': 1.0,
                                 'w_yaw': 20.0,
                                 'w_acc': 0.5,
                                 'w_stl': 25.0,
                                 'slove_type': 'barrier',
                                 'alm_rho_init': 20,
                                 'alm_gamma': 0,
                                 'max_rho': 20,
                                 'max_mu': 100,
                                 'obstacle_exp_q1': 5.5,
                                 'obstacle_exp_q2': 5.75,
                                 'state_exp_q1': 3.0,
                                 'state_exp_q2': 3.5,
                                 'use_last_solution': False},
                         'iteration': {'max_iter': 100,
                                       'init_lamb': 0,
                                       'lamb_decay': 0.5,
                                       'lamb_amplify': 2.0,
                                       'max_lamb': 1000.0,
                                       'convergence_threshold': 0.01,
                                       'accept_step_threshold': 0.5},
                         'laneline': {'reference': {'x': [-20,
                                                          -5,
                                                          10,
                                                          20,
                                                          35,
                                                          70,
                                                          100,
                                                          150],
                                                    'y': [1,
                                                          1,
                                                          1,
                                                          5,
                                                          6.5,
                                                          0,
                                                          0,
                                                          0]},
                                      'border': [-1.8, 1.8, 5.4, 9],
                                      'center_line': [0, 3.6, 7.2]},
                         'initial_condition': [[-10, 1, 4, 0],
                                               [10, 0, 4, 0.5236],
                                               [25, 10, 4, 0.5236],
                                               [-15, 9, 8, 0]],
                         'visualization': {'y_lim': [-3, 23],
                                           'show_reference_line': False,
                                           'show_obstacle_boundary': False}}}


@pytest.mark.parametrize("name", ["scenario_two_straight",
                                  "scenario_two_borrow",
                                  "scenario_three_straight",
                                  "scenario_three_bend"])
def test_config_parser_reads_shipped_yamls(name):
    with open(os.path.join(CONFIG_DIR, name + ".yaml")) as f:
        got = parse_yaml(f.read())
    assert got == _LITERAL[name]


def test_config_parser_subset_rules():
    text = ('a: 1  # comment\nb:\n  c: "x # not a comment"\n  d: [1, 2.5, -3]\n'
            'e:\n  - [1, 2]\n  - [3, 4]\nf: true\ng: 1e-3\n')
    assert parse_yaml(text) == {"a": 1, "b": {"c": "x # not a comment",
                                              "d": [1, 2.5, -3]},
                                "e": [[1, 2], [3, 4]], "f": True, "g": 1e-3}
