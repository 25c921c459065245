"""Kidnap detection (counterpart of cerebro_tpu.kidnap)."""

from cerebro_tpu_torch.kidnap.monitor import KidnapEvent, KidnapMonitor

__all__ = ["KidnapEvent", "KidnapMonitor"]
