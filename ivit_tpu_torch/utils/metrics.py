"""Console and log metering: ``AverageMeter`` and ``MetricLogger``.

Counterpart of ``ivit_tpu/utils/metrics.py``, with the same printed
lines (the reference's ``AverageMeter`` and ``MetricLogger`` with its
ETA). Values are Python numbers: the caller reads a metric off the
device before it updates a meter.
"""

from __future__ import annotations

import datetime
import logging
import time


class AverageMeter:
    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg
        )


class MetricLogger:
    """Periodic progress lines with step time and ETA."""

    def __init__(self, total_steps: int, prefix: str = "", print_freq: int = 100):
        self.total = total_steps
        self.prefix = prefix
        self.print_freq = print_freq
        self.meters: dict[str, AverageMeter] = {}
        self._t0 = time.time()
        self._last = self._t0
        self.step_time = AverageMeter("time", ":.3f")

    def meter(self, name: str, fmt: str = ":.4f") -> AverageMeter:
        if name not in self.meters:
            self.meters[name] = AverageMeter(name, fmt)
        return self.meters[name]

    def update(self, **kv):
        now = time.time()
        self.step_time.update(now - self._last)
        self._last = now
        for k, v in kv.items():
            self.meter(k).update(v)

    def log(self, step: int):
        if step % self.print_freq != 0 and step != self.total - 1:
            return
        eta = self.step_time.avg * (self.total - step - 1)
        parts = [f"{self.prefix}[{step}/{self.total}]", str(self.step_time)]
        parts += [str(m) for m in self.meters.values()]
        parts.append(f"eta {datetime.timedelta(seconds=int(eta))}")
        logging.info("  ".join(parts))
