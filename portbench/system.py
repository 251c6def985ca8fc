"""The system under test, built from a configuration file.

This is the one module of the benchmark that imports the program,
``meters_lv2_torch``, and it imports nothing else of the repo.  A
configuration names its meters by the program's registry names and one
entry:

  * ``meter``: the configuration's single meter, fed flat channel-major
    blocks [B, C*T] (``update(state, x, flat=True)``), the port's main path;
  * ``pipeline``: ``parallel/pipeline.py::MeterPipeline`` over every meter,
    fed [B, C, T].

``readouts`` picks, from what ``read`` returned and from the state, the
leaves the reference judges, by the names the reference module of each
meter's kind declares, each [B, ...].
"""

from __future__ import annotations

import torch

import meters_lv2_torch as mt
from meters_lv2_torch.parallel.pipeline import MeterPipeline


class System:
    def __init__(self, config: dict, device):
        self.fs = config["fs"]
        self.nchan = config["nchan"]
        self.entry = config["entry"]
        self.device = device
        self.meters = {name: mt.create(m["kind"], self.fs, **m.get("args", {}))
                       for name, m in config["meters"].items()}
        if self.entry == "pipeline":
            self.pipe = MeterPipeline(self.meters, nchan=self.nchan)
        elif self.entry == "meter":
            if len(self.meters) != 1:
                raise ValueError("entry 'meter' takes one meter")
            (self.name, self.meter), = self.meters.items()
        else:
            raise ValueError(f"unknown entry {self.entry!r}")

    def init(self, batch: int):
        if self.entry == "pipeline":
            return self.pipe.init((batch,), device=self.device)
        return self.meter.init((batch,), device=self.device)

    def update(self, state, x: torch.Tensor):
        """x [B, C, T] (a contiguous block of the pool)."""
        if self.entry == "pipeline":
            return self.pipe.update(state, x)
        B, C, T = x.shape
        return self.meter.update(state, x.view(B, C * T), flat=True)

    def read(self, state):
        if self.entry == "pipeline":
            return self.pipe.read(state)
        outs, state = self.meter.read(state)
        return {self.name: outs}, {self.name: state}

    def readouts(self, outs: dict, state, names: dict) -> dict:
        """names: meter name -> (readout keys, state keys).  Returns
        {"<meter>.<key>": tensor [B, ...]}; a readout that is one tensor
        has the key "value", and a per-channel meter's [B, C] leaves keep
        their channel axis."""
        if self.entry == "meter":
            state = {self.name: state}
        got = {}
        for meter, (rkeys, skeys) in names.items():
            o = outs.get(meter)
            for k in rkeys:
                got[f"{meter}.{k}"] = o if k == "value" else o[k]
            for k in skeys:
                got[f"{meter}.{k}"] = getattr(state[meter], k)
        return got
