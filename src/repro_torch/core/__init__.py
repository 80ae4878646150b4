"""OPD — the paper's contribution: MDP model, LSTM workload predictor,
residual feature extraction, PPO policy with expert guidance, baselines.
The NumPy parts are bit-identical to ``repro.core``; the networks and the
vectorized analytic env, the discrete-event runtime twin and the load
forecaster run on a torch device; proactive pre-warm control is NumPy."""
from repro_torch.core.mdp import (ModelVariant, Task, Pipeline, Config, QoSWeights,
                                  pipeline_metrics, qos, objective, reward, feasible,
                                  resource_usage)
from repro_torch.core.predictor import (init_predictor, predict_batch, train_predictor,
                                        smape, as_predictor_fn, HISTORY, HORIZON)
from repro_torch.core.features import init_features, extract, FEATURE_DIM
from repro_torch.core.policy import (init_policy, apply_policy, sample_action,
                                     log_prob_entropy, head_sizes, action_to_config,
                                     config_to_action)
from repro_torch.core.ppo import PPOConfig, OPDTrainer, compute_gae
from repro_torch.core.vecenv import (PipelineTables, EnvState, tables_from_pipeline,
                                     init_state, decode_action, observe, step,
                                     rollout, vec_rollout, gae_scan, vec_gae)
from repro_torch.core.expert import CapacityPolicy, ExpertPolicy, capacity_config
from repro_torch.core.baselines import RandomPolicy, GreedyPolicy, IPAPolicy
from repro_torch.core.opd import OPDPolicy, run_episode, run_episodes_vectorized
from repro_torch.core.controller import Observation, ControllerBase, decide
from repro_torch.core.forecast import (init_forecaster, forecast_batch,
                                       train_forecaster, smape_horizons,
                                       pinball_horizons, as_forecast_fn,
                                       make_forecast_dataset, telemetry_trace,
                                       HORIZONS)
from repro_torch.core.proactive import ProactiveController
