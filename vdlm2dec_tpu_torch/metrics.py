"""Per-stage decode metrics — the framework's observability surface.

The reference has no counters (failures are silently dropped or gated behind
verbose>2, SURVEY.md section 5); here sync attempts, RS corrections, CRC
pass rate and throughput are first-class.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


@dataclass
class PipelineMetrics:
    samples_in: int = 0              # wideband samples consumed
    decimated_samples: int = 0       # 84 kHz samples produced
    sync_candidates: int = 0         # raw triggers from the scan
    bursts_attempted: int = 0        # header-accepted bursts
    bursts_rejected_header: int = 0  # len<96 / nbrow>8 rejects
    rs_rows: int = 0
    rs_corrected_rows: int = 0       # rows with count > 0
    rs_corrections: int = 0          # total corrected bytes
    rs_failures: int = 0             # uncorrectable rows
    frames_crc_ok: int = 0
    frames_emitted: int = 0          # after L5 filters
    candidates_overflow: int = 0     # triggers dropped: max_out slots full
    wall_start: float = field(default_factory=time.time)
    device_time_s: float = 0.0       # dispatch-to-fetch time of device blocks

    def observe_bursts(self, bursts) -> None:
        for b in bursts:
            self.bursts_attempted += 1
            for cnt in b.rs_counts:
                self.rs_rows += 1
                if cnt > 0:
                    self.rs_corrected_rows += 1
                    self.rs_corrections += cnt
                elif cnt < 0:
                    self.rs_failures += 1
            self.frames_crc_ok += len(b.frames)

    def snapshot(self) -> dict:
        wall = max(time.time() - self.wall_start, 1e-9)
        return {
            "samples_in": self.samples_in,
            "decimated_samples": self.decimated_samples,
            "sync_candidates": self.sync_candidates,
            "bursts_attempted": self.bursts_attempted,
            "bursts_rejected_header": self.bursts_rejected_header,
            "rs_rows": self.rs_rows,
            "rs_corrected_rows": self.rs_corrected_rows,
            "rs_corrections": self.rs_corrections,
            "rs_failures": self.rs_failures,
            "frames_crc_ok": self.frames_crc_ok,
            "frames_emitted": self.frames_emitted,
            "candidates_overflow": self.candidates_overflow,
            "wall_s": round(wall, 3),
            "device_time_s": round(self.device_time_s, 3),
            "samples_per_s": round(self.samples_in / wall, 1),
            "crc_pass_per_burst": round(
                self.frames_crc_ok / max(self.bursts_attempted, 1), 4
            ),
        }

    def report(self) -> str:
        return json.dumps(self.snapshot())
