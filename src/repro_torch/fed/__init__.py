from repro_torch.fed.async_engine import (BufferedAsyncSimulation,
                                          staleness_weight)
from repro_torch.fed.clock import (ClientClock, Timeline, make_clock,
                                   simulate_timeline)
from repro_torch.fed.population import SAMPLERS, ClientPopulation
from repro_torch.fed.simulation import (FederatedSimulation, History,
                                        compare_algorithms)

__all__ = ["BufferedAsyncSimulation", "ClientClock", "ClientPopulation",
           "FederatedSimulation", "History", "SAMPLERS", "Timeline",
           "compare_algorithms", "make_clock", "simulate_timeline",
           "staleness_weight"]
