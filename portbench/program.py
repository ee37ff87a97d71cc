"""The system under test: the entry points of ``ryg_rans_tpu_torch`` that a
configuration names, called as a user calls them, with the arguments that
the configuration gives.

``inputs_on: "host"``: ``encode(data: bytes) -> bytes`` and ``decode(blob)
-> bytes``.  ``inputs_on: "device"``: ``encode(t: uint8 tensor) -> bytes``
and ``decode(blob) -> uint8 tensor``, the device synchronised before the
call returns so that the tensor is usable.

The configuration's ``rans_config`` is passed as a ``RansConfig``, or not
at all where its rule is ``auto`` (the entry point then picks the shape by
the input's size); an optional ``backend`` (``"native"``, ``"numpy"``) is
passed to the host-bytes entry points.  ``reference.config.shape_of``
reads the same keys for the reference.  The package is imported here and
nowhere else in the harness.
"""

from __future__ import annotations

import importlib

import torch


def rans_config(rt, spec: dict):
    """The ``RansConfig`` that ``spec`` (a configuration's
    ``rans_config``) states, or None for the ``auto`` rule."""
    if spec["rule"] == "auto":
        return None
    if spec["rule"] != "explicit":
        raise ValueError(f"no rans_config rule {spec['rule']!r}")
    return rt.RansConfig(variant=rt.Variant[spec["variant"]],
                         prob_bits=spec["prob_bits"],
                         n_lanes=spec["n_lanes"],
                         block_symbols=spec["block_symbols"],
                         checksum=spec["checksum"])


class Program:
    def __init__(self, config: dict, device: torch.device):
        import ryg_rans_tpu_torch as rt

        self.device = torch.device(device)
        self.on_device = config["inputs_on"] == "device"
        self._enc = getattr(rt, config["entry_points"]["encode"])
        self._dec = getattr(rt, config["entry_points"]["decode"])
        self._cfg = rans_config(rt, config["rans_config"])
        self._host = {"device": self.device}
        if config.get("backend") is not None:
            if self.on_device:
                raise ValueError("a backend codes host bytes: "
                                 "inputs_on must be host")
            self._host = {"backend": config["backend"]}

    def encode(self, x) -> bytes:
        if self.on_device:
            return self._enc(x, self._cfg)
        return self._enc(x, self._cfg, **self._host)

    def decode(self, blob):
        if self.on_device:
            out = self._dec(blob, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return out
        return self._dec(blob, **self._host)

    @staticmethod
    def launches(counter: str) -> int | None:
        """The launch counter ``module:function`` of a kernel's wrapper
        (``function.launches``), as the program keeps it; None where the
        program has no such module or function (a kernel file added for a
        kernel that this program predates)."""
        module, fn = counter.split(":")
        try:
            mod = importlib.import_module(module)
        except ModuleNotFoundError as e:
            if module == e.name or module.startswith(f"{e.name}."):
                return None
            raise
        wrapper = getattr(mod, fn, None)
        return None if wrapper is None else int(wrapper.launches)
