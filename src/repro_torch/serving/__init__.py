from repro_torch.serving.engine import Completion, Request, ServeEngine
from repro_torch.serving.loadgen import LoadGen, latency_stats, replay
from repro_torch.serving.personalized import (PERSONALIZERS,
                                              PersonalizedServeEngine,
                                              load_snapshot, lowrank_factors,
                                              make_personalizer,
                                              make_snapshot,
                                              personalized_decode,
                                              save_snapshot)

__all__ = ["Completion", "Request", "ServeEngine", "LoadGen", "replay",
           "latency_stats", "PERSONALIZERS", "PersonalizedServeEngine",
           "load_snapshot", "lowrank_factors", "make_personalizer",
           "make_snapshot", "personalized_decode", "save_snapshot"]
