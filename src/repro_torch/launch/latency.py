"""Latency dissection on the card: the paper's §4.1 and ch.3 methods.

  python -m repro_torch.launch.latency               # on the card
  python -m repro_torch.launch.latency --device cpu  # rehearsal

Prints (1) Table 4.1 as the scoreboard model recovers it by the paper's
control-word method, (2) nanoseconds per dependent application of each op
of ``core.latency.standard_op_suite`` (one CUDA graph a chain on the card),
and (3) nanoseconds per dependent load of the ``pchase`` kernel over random
line chains of growing footprint, from the L1 out to device memory. On the
CPU, (2) and (3) time PyTorch's CPU ops and the chase's plain version at
the smaller footprints: a rehearsal, not a device number.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import hwmodel, latency


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "host CPU (plain versions; not a device number)")

    recovered = {}
    for arch, table in (("volta", hwmodel.VOLTA_INSTR_LATENCY),
                        ("pascal", hwmodel.PASCAL_INSTR_LATENCY)):
        board = latency.Scoreboard(table)
        ok = sum(latency.measure_fixed_latency(board, op, 100) == lat
                 for op, lat in table.items())
        recovered[arch] = (ok, len(table))
        print(f"table 4.1 {arch}: {ok}/{len(table)} latencies recovered by "
              f"the stall-shrinking method")

    x0 = torch.zeros(8, device=dev)
    op_ns = {name: latency.measure_op_chain(fn, x0)
             for name, fn in latency.standard_op_suite().items()}
    print(f"dependent op chains on {where}, ns per application: "
          + ", ".join(f"{k} {v:.1f}" for k, v in op_ns.items()))

    footprints = (latency.FOOTPRINTS if dev.type == "cuda"
                  else [f for f in latency.FOOTPRINTS if f <= 2**20])
    chase_ns = {}
    for fp in footprints:
        chase_ns[fp] = latency.chase_ns_per_step(fp, device=dev)
        print(f"pointer chase on {where}: {fp / 2**10:.0f} KiB footprint, "
              f"{latency.LINE_BYTES}-byte lines, {latency.STEPS} steps: "
              f"{chase_ns[fp]:.2f} ns per dependent load")
    return {"device": where, "table_4_1": recovered, "op_chain_ns": op_ns,
            "chase_ns": chase_ns}


if __name__ == "__main__":
    main()
