"""Assert-on-overwrite dict: the data bus that the evaluation's loaders fill
(counterpart of hold_tpu/utils/databus.py, without its registration as a JAX
pytree, and with only what the port calls: setting a key once and
``search``).

Mirrors the role of the reference's ``common/xdict.py:26``.
"""

from __future__ import annotations

from typing import Any


class DataBus(dict):
    """A dict that refuses silent overwrites."""

    def __setitem__(self, key: str, value: Any) -> None:
        if key in self:
            raise KeyError(f"DataBus key '{key}' already exists")
        super().__setitem__(key, value)

    def search(self, pattern: str) -> "DataBus":
        """The entries whose key contains ``pattern``."""
        out = DataBus()
        for k, v in self.items():
            if pattern in k:
                out[k] = v
        return out
