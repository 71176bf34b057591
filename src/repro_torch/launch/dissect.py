"""The paper, end to end: dissect a card with black-box pointer-chase probes.

  python -m repro_torch.launch.dissect --model V100 --device cpu
  python -m repro_torch.launch.dissect --model all
  python -m repro_torch.launch.dissect              # the card itself

With ``--model`` (V100, P100, P4, M60, K80 or all) it dissects the device
models of the paper's Table 3.1 (``core.dissect``, numpy: it runs the same
on any device), with Table 3.3 for the V100 and Ch.1's NVCC register
mapping against the conflict-free remapping in GFLOPS/SM: the counterpart
of the reference's ``examples/dissect_v100.py``. Without ``--model`` it
runs the same detectors on the CUDA card (``core.card.dissect_card``);
``--device`` defaults to ``cuda`` and there is no CPU fallback. It prints
one JSON report.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch import resolve_device
from repro_torch.core import card, dissect, hwmodel, regbank, regremap

MODELS = tuple(hwmodel.GPUS)


# The V100's boost clock, at which the paper states Table 1.1's GFLOPS.
CH1_CLOCK_MHZ = 1380.0


def ch1() -> dict:
    """Table 1.1: the NVCC listing against the remapped tile, modelled on
    the V100's register file at ``CH1_CLOCK_MHZ``."""
    rf = hwmodel.V100.regfile
    nvcc = regbank.parse_listing(regbank.NVCC_LISTING)
    ours = regremap.remap_tile(rf, regbank.A_REGS, regbank.B_REGS,
                               list(range(16, 80)))
    g0 = regbank.gflops_per_sm(rf, nvcc, CH1_CLOCK_MHZ)
    g1 = regbank.gflops_per_sm(rf, ours, CH1_CLOCK_MHZ)
    return {"clock_mhz": CH1_CLOCK_MHZ, "nvcc_gflops_per_sm": g0,
            "remapped_gflops_per_sm": g1, "gain": g1 / g0 - 1,
            "conflict_free": regremap.conflict_free(rf, ours),
            "paper_gflops_per_sm": [regbank.PAPER_GFLOPS_NVCC,
                                    regbank.PAPER_GFLOPS_IMPROVED]}


def model_report(names) -> dict:
    out = {"models": {}}
    for name in names:
        rep = dissect.dissect(hwmodel.GPUS[name])
        out["models"][name] = dataclasses.asdict(rep)
    if "V100" in names:
        out["table_3_3"] = dissect.table_3_3(hwmodel.V100)
    out["ch1"] = ch1()
    return out


def card_report(device) -> dict:
    rep = card.dissect_card(device)
    d = dataclasses.asdict(rep)
    d["ns"] = {k: rep.ns(v) for k, v in rep.steady.items()}
    d["classes_ns"] = [rep.ns(c) for c in rep.classes]
    return {"card": d, "device": torch.cuda.get_device_name(device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=MODELS + ("all",), default=None,
                    help="dissect this device model instead of the card")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model is not None:
        report = model_report(MODELS if args.model == "all"
                              else (args.model,))
    else:
        report = card_report(resolve_device(args.device))
    print(json.dumps(report, default=str))
    return report


if __name__ == "__main__":
    main()
