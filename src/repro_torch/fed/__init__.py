from repro_torch.fed.population import SAMPLERS, ClientPopulation
from repro_torch.fed.simulation import (FederatedSimulation, History,
                                        compare_algorithms)

__all__ = ["ClientPopulation", "FederatedSimulation", "History", "SAMPLERS",
           "compare_algorithms"]
