from repro_torch.federated.events import (ArrivalProcess, BernoulliDropout,
                                          DropoutProcess, Event,
                                          JitteredArrival, SimClock)
from repro_torch.federated.heterogeneity import (CAPABLE, TABLE_I, cycle_time,
                                                 make_fleet)
from repro_torch.federated.runtime import (AsyncFLRun, BatchedFLRun, Client,
                                          FLRun, ShardedFLRun, setup_clients)
from repro_torch.federated.schemes import (SCHEMES, AfoScheme, AsynScheme,
                                           DelayedScheme, FluidScheme,
                                           ScaffoldScheme, Scheme,
                                           make_scheme)

__all__ = ["AfoScheme", "ArrivalProcess", "AsyncFLRun", "AsynScheme",
           "BatchedFLRun", "BernoulliDropout", "CAPABLE", "Client",
           "DelayedScheme", "DropoutProcess", "Event", "FLRun", "FluidScheme",
           "JitteredArrival", "SCHEMES", "ScaffoldScheme", "Scheme",
           "ShardedFLRun", "SimClock", "TABLE_I", "cycle_time", "make_fleet",
           "make_scheme", "setup_clients"]
