from repro_torch.serving.engine import Completion, Request, ServeEngine
from repro_torch.serving.loadgen import LoadGen, latency_stats, replay

__all__ = ["Completion", "Request", "ServeEngine", "LoadGen", "replay",
           "latency_stats"]
