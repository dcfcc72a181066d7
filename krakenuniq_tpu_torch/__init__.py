"""krakenuniq_tpu_torch -- the PyTorch/CUDA port of krakenuniq_tpu.

The resident, single-device classify path (CHD hash table over value-pool
ids, Python host route) on an NVIDIA H100, with host or device-resident
(`--device-counters`) per-taxon counters: the k-mer front, the CHD probe,
the tree-resolution score count, the per-taxon counts and the HLL register
max run as hand-written CUDA kernels (`csrc/`, bound in `_kernels.py`), as
does the row fetch of the probe tool (`tools/probe_gather.py`); everything
else is plain PyTorch on the device and numpy on the host. Module paths mirror krakenuniq_tpu so each
counterpart is found by name.

Device planes hold unsigned bit patterns in signed tensors: uint64 values as
int64, uint32 values as int32 (`ints.py` has the unsigned helpers). Entry
points run on "cuda" unless the caller asks for "cpu"; on a CPU tensor every
kernel wrapper computes its plain PyTorch version instead.
"""

__version__ = "0.1.0"
