"""The paper's own 'architecture': the V100 dissection configuration.

The reference's ``repro/configs/v100_microbench.py``: the card whose
device model ``launch/dissect.py --model V100`` dissects, and the probes
of the ch.3/ch.4 suite. It configures no language model, so it is not
among ``list_archs()``."""
from repro_torch.core import hwmodel

GPU = hwmodel.V100
PROBES = ("l1", "l2", "tlb", "latency_classes", "register_banks",
          "shared_memory", "constant_cache", "table_1_1", "table_2_1")
