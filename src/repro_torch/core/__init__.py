"""The paper's measurement methods and device models, for the port.

* ``hwmodel``  — the paper's Table 4.1 latency tables and the H100's
  published limits (the GEMM tile chooser prices against these);
* ``latency``  — the §4.1 scoreboard model with its control-word method,
  and the wall-clock harnesses on the card: dependent op chains and the
  ch.3 pointer chase;
* ``autotune`` — the blocked GEMM's cost model and tile chooser (Ch.1).
"""
