"""The OPD control half of the port (so far: ``mdp.Config``)."""
from repro_torch.core.mdp import Config
