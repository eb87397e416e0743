from repro_torch.federated.heterogeneity import (CAPABLE, TABLE_I, cycle_time,
                                                 make_fleet)
from repro_torch.federated.runtime import Client, FLRun, setup_clients
from repro_torch.federated.schemes import SCHEMES, make_scheme

__all__ = ["CAPABLE", "Client", "FLRun", "SCHEMES", "TABLE_I", "cycle_time",
           "make_fleet", "make_scheme", "setup_clients"]
