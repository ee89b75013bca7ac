"""The system under test: the port's ``VisionEngine`` on a registered
model's graph.  The only module of the benchmark that imports the port;
from it the benchmark takes the engine, its counters and the dataflow each
compiled layer runs, nothing else."""
from __future__ import annotations

import pathlib
import sys

SRC = pathlib.Path(__file__).resolve().parents[2] / "src"


def _port():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch.models.zoo import get_conv_model
    from repro_torch.serve.transport import EngineWorker
    from repro_torch.serve.vision import VisionEngine
    return get_conv_model, VisionEngine, EngineWorker


class System:
    """One engine over ``params`` (the benchmark's own fp32 tensors), with
    the configuration's buckets, the CUDA graphs on (the serving default)
    and no autotuning."""

    def __init__(self, cfg: dict, params: dict, device):
        if cfg["precision"] != "fp32":
            raise ValueError(f"precision {cfg['precision']!r}: the "
                             "benchmark serves fp32 configurations")
        get_conv_model, VisionEngine, self._worker_cls = _port()
        spec = get_conv_model(cfg["program_model"])
        self.engine = VisionEngine(
            params, spec.to_graph(), img=cfg["img"],
            buckets=tuple(cfg["buckets"]), device=device,
            precision="fp32", autotune=False, jit=True)

    def warmup(self) -> None:
        """Every bucket once: kernel library, plans, captures."""
        self.engine.warmup()

    def worker(self):
        """An ``EngineWorker`` thread over the engine (not started)."""
        return self._worker_cls("portbench", self.engine)

    def counters(self) -> dict:
        m = self.engine.metrics
        return {"images": m.images, "batches": m.batches,
                "host_s": m.host_s, "degraded_batches": m.degraded_batches}

    def dataflows(self, bucket: int) -> list:
        """(layer name, dataflow) of the bucket's compiled network."""
        net = self.engine.compiler.network_for(bucket)
        return [(name, s.dataflow) for name, s in net.layer_schedules]

    @staticmethod
    def build_seconds() -> float:
        """Seconds this process spent building the kernel library (0.0
        where an earlier run built it)."""
        from repro_torch.kernels.build import build_info
        return float(build_info()["seconds"])
