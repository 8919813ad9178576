"""The program under test, built from the benchmark's inputs through its
normal entry points: the VAE, the latent dictionary and the pipeline."""

from __future__ import annotations

import os
import resource
import time

import numpy as np
import torch

__all__ = ["database", "host_counters", "memory_peak", "model", "pipeline", "reset_memory", "sync",
           "Stopwatch"]


def model(cfg: dict, params: dict, device):
    """The port's VAE at ``cfg``'s widths, in its precision, carrying
    ``params`` (the benchmark's draw)."""
    from latice_tpu_torch.models import VariationalAutoEncoderRawData

    m = VariationalAutoEncoderRawData(
        inplanes=cfg["inplanes"], latent_dim=cfg["latent_dim"], n_stages=cfg["n_stages"],
        bottleneck_hw=cfg["bottleneck_hw"],
    ).to(device)
    m.load_state_dict(params, strict=True)
    return m.set_precision(cfg["precision"])


def database(cfg: dict, vectors: np.ndarray, euler: np.ndarray, phases: np.ndarray, device,
             scratch: str):
    """The port's in-memory latent dictionary; ``scratch`` is a path that
    does not exist, so nothing is read or written."""
    from latice_tpu_torch.index import LatentVectorDatabaseConfig, TorchLatentVectorDatabase

    multi = len(cfg["phases"]) > 1
    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=scratch, dimension=cfg["latent_dim"],
                                   phase_symmetries=list(cfg["phases"]) if multi else None),
        device=device,
    )
    db.add_vectors(vectors, euler, phases if multi else None)
    return db


def pipeline(cfg: dict, net, db, batch_size: int, device):
    """`IndexPipeline` over ``db`` with ``cfg``'s search and consensus, as
    ``index query`` builds it."""
    from latice_tpu_torch.index import IndexPipeline

    phase_kw = {}
    if db._has_phases:
        phase_kw = dict(dictionary_phases=db._phases, phase_symmetries=db.config.phase_symmetries)
    return IndexPipeline(
        net, db._vectors, db._orientations, top_n=cfg["top_n"],
        orientation_threshold=cfg["threshold_deg"], min_required_matches=cfg["min_matches"],
        max_iterations=cfg["max_iterations"], batch_size=batch_size, engine=cfg["engine"],
        device=device, **phase_kw,
    )


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_memory(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def host_counters(since: dict | None = None, seconds: float | None = None) -> dict:
    """This process's CPU seconds; given ``since`` (the counters at the
    start of a window of ``seconds``), the change over the window, its
    share of the window in cores and the cores the process may use."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    now = {"user_s": ru.ru_utime, "sys_s": ru.ru_stime}
    if since is None:
        return now
    out = {k: v - since[k] for k, v in now.items()}
    out["cpu_share"] = (out["user_s"] + out["sys_s"]) / seconds
    out["cores"] = len(os.sched_getaffinity(0))
    return out


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Stopwatch:
    """Opens a profiled window (`trace.Window`) inside a loop, at the first
    unit boundary after ``start_s`` of the window, and closes it at the
    first after ``start_s + length_s``; off unless ``spans`` is given."""

    def __init__(self, spans, start_s: float, length_s: float, t0: float) -> None:
        from port_bench import trace

        self.window = None if spans is None else trace.Window(spans)
        self.t_start, self.t_stop = t0 + start_s, t0 + start_s + length_s
        self.active = self.done = False

    def tick(self) -> None:
        """Call at each unit boundary."""
        if self.window is None or self.done:
            return
        now = time.time()
        if not self.active and now >= self.t_start:
            self.window.start()
            self.active = True
        elif self.active and now >= self.t_stop:
            self.stop()

    def stop(self) -> None:
        if self.active:
            self.window.stop()
            self.active, self.done = False, True

    def read(self):
        return self.window.read() if self.done else None
