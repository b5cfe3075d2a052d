"""Beyond-paper ablation: int8-quantized transmission.

The paper cites gradient compression as orthogonal related work (§2); here
it is measured on FedaGrac's uploads through the compression stage
(core/compress.py): ``FedConfig.compressor="int8"`` applies per-row
symmetric int8 fake-quantization with error feedback to both wire
quantities — the parameter delta and the ν orientation — 4× fewer uplink
bytes than fp32.  Claim examined: calibration quality survives 8-bit
transmission.

The twin of ``benchmarks/ablation_int8_nu.py``, on the port, and like it on
the tree layout (``FedConfig``'s default): the compressed tree round sends
its wire rows through the flat view table, so on the card the quantize
kernels run on it.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import bimodal_schedule, emit, make_task
from repro_torch.configs.base import FedConfig
from repro_torch.fed import FederatedSimulation

T, T_QUICK = 50, 15
TARGET = 0.77


def run(quick: bool = False, device=None) -> list[tuple]:
    t = T_QUICK if quick else T
    rows = []
    ks = bimodal_schedule()
    for comp in ("none", "int8"):
        task = make_task("lr", noniid=True, device=device)
        fed = FedConfig(algorithm="fedagrac", n_clients=task.batcher.m,
                        lr=task.lr, calibration_rate=1.0, weights="data",
                        compressor=comp)
        sim = FederatedSimulation(task.loss_fn, task.params, fed,
                                  task.batcher, eval_fn=task.eval_fn,
                                  k_schedule=ks, device=task.device)
        hist = sim.run(t)
        rows.append(("int8_nu", "int8" if comp == "int8" else "fp32",
                     round(hist.metric[-1], 4),
                     hist.rounds_to_target(TARGET) or f">{t}"))
    return rows


def main(quick: bool = False, device=None) -> None:
    emit(run(quick, device), ("bench", "nu_dtype", "final_acc",
                              "rounds_to_077"))
