"""The paper's measurement methods and device models, for the port.

* ``hwmodel``  — the paper's cards (Table 3.1, ``PaperGPUSpec``: V100, P100,
  P4, M60, K80), its Table 4.1/4.2 latencies, and the H100's published
  limits (the GEMM tile chooser prices against these);
* ``simulator``, ``pchase``, ``dissect`` — the ch.3 device model, the
  pointer-chase detectors and the Table 3.1 dissection (copies of the
  reference's); ``card`` — the same detectors on the H100 itself, through
  the clock-timed chase kernel;
* ``regbank``, ``regremap`` — the register-bank model and Ch.1's
  conflict-free remapping; ``scheduler``, ``atomics``, ``tensorcore``,
  ``isa`` — Table 2.1, Table 4.2, the HMMA fragment maps and the
  control-word codec (copies of the reference's);
* ``latency``  — the §4.1 scoreboard model with its control-word method,
  and the wall-clock harnesses on the card: dependent op chains and the
  ch.3 pointer chase;
* ``autotune`` — the blocked GEMM's cost model and tile chooser (Ch.1) and
  the serving cost models; ``calibrate`` — their constants measured on the
  card.
"""
