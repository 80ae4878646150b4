"""Cluster model of the port: topology and placement, the analytic perf
model, workload traces, the monitor and the two MDP environments (NumPy,
bit-identical to ``repro.cluster``), and measured execution
(``cluster.executor``, on a torch device) with its calibration
(``cluster.calibration``, NumPy)."""
from repro_torch.cluster.topology import (ClusterTopology, Node, Placement,
                                          PlacementCursor)
from repro_torch.cluster.workloads import make_trace, WORKLOADS
from repro_torch.cluster.perf_model import (variant_from_arch, default_pipeline,
                                            make_pipeline)
from repro_torch.cluster.env import (PipelineEnv, RuntimeEnv, ADAPTATION_INTERVAL,
                                     COLD_START_FRACTION)
from repro_torch.cluster.monitor import Monitor
from repro_torch.cluster.calibration import (CalibrationTable, calibrate_pipeline,
                                             apply_to_cluster, fit_alpha_beta,
                                             register_table, resolve_table)
