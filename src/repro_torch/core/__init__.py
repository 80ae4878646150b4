"""The control half of the port: the paper's MDP model and its non-learned
controllers (NumPy, bit-identical to ``repro.core``). The learned half (LSTM
predictor, features, policy, PPO, OPD) comes with ROADMAP Queue 1 item 3."""
from repro_torch.core.mdp import (ModelVariant, Task, Pipeline, Config, QoSWeights,
                                  pipeline_metrics, qos, objective, reward, feasible,
                                  resource_usage)
from repro_torch.core.expert import CapacityPolicy, ExpertPolicy, capacity_config
from repro_torch.core.baselines import RandomPolicy, GreedyPolicy, IPAPolicy
from repro_torch.core.controller import Observation, ControllerBase, decide
