from repro_torch.fed.async_engine import (BufferedAsyncSimulation,
                                          staleness_weight)
from repro_torch.fed.clock import (ClientClock, Timeline, make_clock,
                                   simulate_timeline)
from repro_torch.fed.population import SAMPLERS, ClientPopulation
from repro_torch.fed.scenarios import (SCENARIOS, Scenario, diurnal_scenario,
                                       dropout_scenario, flaky_scenario,
                                       garbage_scenario, inf_inject_scenario,
                                       make_scenario, nan_inject_scenario,
                                       scale_attack_scenario,
                                       sign_flip_scenario, spike_scenario,
                                       trace_scenario)
from repro_torch.fed.simulation import (FederatedSimulation, History,
                                        compare_algorithms)

__all__ = ["BufferedAsyncSimulation", "ClientClock", "ClientPopulation",
           "FederatedSimulation", "History", "SAMPLERS", "SCENARIOS",
           "Scenario", "Timeline", "compare_algorithms", "diurnal_scenario",
           "dropout_scenario", "flaky_scenario", "garbage_scenario",
           "inf_inject_scenario", "make_clock", "make_scenario",
           "nan_inject_scenario", "scale_attack_scenario",
           "sign_flip_scenario", "simulate_timeline", "spike_scenario",
           "staleness_weight", "trace_scenario"]
