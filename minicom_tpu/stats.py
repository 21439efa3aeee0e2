"""Structured per-stage timing & counters (replaces the reference's two stage
banners, preprocess.c:186,235, and its disabled [M::func] log lines)."""

from __future__ import annotations

import contextlib
import json
import time


class StageStats:
    def __init__(self):
        self.timings: dict[str, float] = {}
        self.counters: dict[str, int | float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        # per-stage device attribution: wall the host spent blocked on the
        # device + bytes across the link during this stage (mesh.py
        # accounting)
        from minicom_tpu.parallel import mesh
        d0, b0 = mesh.device_seconds(), mesh.device_bytes()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0
            ds = mesh.device_seconds() - d0
            db = mesh.device_bytes() - b0
            if ds > 1e-4 or db:
                self.counters[f"device_{name}_s"] = round(
                    self.counters.get(f"device_{name}_s", 0.0) + ds, 3)
                self.counters[f"device_{name}_bytes"] = \
                    self.counters.get(f"device_{name}_bytes", 0) + db

    def set(self, key: str, value):
        self.counters[key] = value

    def summary(self) -> dict:
        out = {"timings_s": {k: round(v, 4) for k, v in self.timings.items()},
               **self.counters}
        nbytes = self.counters.get("input_bytes")
        if nbytes:
            out["stage_MBps"] = {
                k: round(nbytes / v / 1e6, 2)
                for k, v in self.timings.items() if v > 1e-9}
        return out

    def dump(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)
