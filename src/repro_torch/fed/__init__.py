from repro_torch.fed.simulation import (FederatedSimulation, History,
                                        compare_algorithms)

__all__ = ["FederatedSimulation", "History", "compare_algorithms"]
