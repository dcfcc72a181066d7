"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` for sm_90a into a
shared library with a plain C interface (`kuniq_<name>`, returning the
`cudaGetLastError()` of its launch) and loaded with ctypes. The libraries go
to `_build/`, named by a hash of their source and of the `csrc/` headers it
includes (`#include "x.cuh"`), so an edited source or header rebuilds and an
unchanged one is reused. `build()` compiles every source at once, one `nvcc`
process each.

`LAUNCHES[name]` counts the kernel launches made through `launch`: the
wrappers (device_step.kmer_front and kmer_front_words, device_step.pack_runs,
device_step.span_dict, device_step.kmer_bins and kmer_bins_words,
device_step.probe_chunk_core, device_step.bsearch_words,
hash_lookup.hash_lookup_kmers, xla_lookup.lookup_kmers,
resolve.scores,
device_counters.taxon_counts, device_counters.hll_regmax,
sparse_exact.sparse_stats, tools.probe_gather.row_gather) call it exactly
where they launch, so a run can show that its main path went through the
kernels. One launch is one call of an entry point, which may put several
records on the card in order on the stream (`RECORDS_PER_LAUNCH`). A
library may hold other launching entry points (`ENTRIES`); each counts
under the name its entry gives: the packed kmer_front under kmer_front,
sparse_stats' key build under its own name, sparse_keys, chd_probe's
out-of-core probe, fused-layout probe and raw two-level probes under their
own, chd_probe_acc, fused_probe, rows_probe and rows_probe_acc, kmer_front's minimizer-bin entries (both feeds) under
kmer_bins, and bsearch_lookup's packed-feed entry under bsearch_words.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
# C signature of each kernel's entry point (pointers and the stream as
# c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    # tins, touts, hit, out, B, W, row stride, lane stride, stream
    "scores": (_P, _P, _P, _P, _I, _I, _L, _I, _P),
    # codes, ambig, hash, enc, kmer_ambig, canon (NULL: not written), B, LB,
    # k, p, stream
    "kmer_front": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # disp, rows, hashes, valid, out, n, lr, lg, stream
    "chd_probe": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
    # ids, mask, acc, n of segment a, the same of segment b, t, shared form,
    # blocks of a, blocks of b, stream
    "taxon_counts": (_P, _P, _P, _L, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    # reg, taxa, enc, lanes, lut (NULL: rows are ids), n, n_ids, n_rows, p, stream
    "hll_regmax": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    # table, q, out, n, n_rows, row_words, depth, copies per lane, stream
    "row_gather": (_P, _P, _P, _L, _L, _I, _I, _I, _P),
    # ids, kmer_ambig, n_kmers, call, hits, map (NULL: none), n_map, out,
    # hll16 (NULL: no feed), hll_stop (NULL: n_kmers), B, W, R, layout, row
    # words, stream
    "pack_runs": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # sorted sign-flipped keys, their permutation, n, th, buf, buf length,
    # n_pairs, n_events, scratch (cleared by sparse_keys), stream
    "sparse_stats": (_P, _P, _L, _I, _P, _L, _P, _P, _P, _P),
    # ids, n, calls, B, T, cap, lut, local, local_call (NULL: no call
    # remap), scratch, stream
    "span_dict": (_P, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P),
    # keys, vals, vals_dense, offsets, query, bins, valid, taxon, taxon_dense,
    # n, n_keys, n_bins, n_iter, bin_start, stream
    "bsearch_lookup": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _L, _P),
}
# launching entry points besides a library's own kuniq_<name>:
# entry -> (library, C signature, the LAUNCHES name it counts under)
ENTRIES = {
    # packed words in, the kmer_front kernel's outputs out
    "kmer_front_packed": ("kmer_front", SIGNATURES["kmer_front"], "kmer_front"),
    # taxa, enc, lanes, unit ids, bytes of a unit id, B, W, keys, scratch,
    # stream: the sort keys of sparse_stats
    "sparse_keys": ("sparse_stats", (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P), "sparse_keys"),
    # packed codes, packed flags, lengths, disp, rows, acc (read and written
    # in place), B, LB, W, k, nt, bin_lo, bin_hi, lr, lg, stream: one chunk
    # table's hits folded into the accumulated words, the lanes whose
    # minimizer bin lies in [bin_lo, bin_hi) probed
    "chd_probe_acc": ("chd_probe", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _I, _I, _P),
                      "chd_probe_acc"),
    # fused, hashes, valid, out, n, lb, stream: the fused two-choice layout
    "fused_probe": ("chd_probe", (_P, _P, _P, _P, _L, _I, _P), "fused_probe"),
    # ptags, confirm, hashes, valid, out, n, lb, stream: the raw two-level
    # layout of UID databases
    "rows_probe": ("chd_probe", (_P, _P, _P, _P, _P, _L, _I, _P), "rows_probe"),
    # packed codes, packed flags, lengths, ptags, confirm, acc, B, LB, W, k,
    # nt, bin_lo, bin_hi, lb, stream: chd_probe_acc's pass over a raw chunk
    # table
    "rows_probe_acc": ("chd_probe", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _I, _P),
                       "rows_probe_acc"),
    # codes (uint8 [B, LB], or the packed words), canon, bin, B, LB, k, nt,
    # stream: the binary-search lookup's canonical k-mers and minimizer bins
    "kmer_bins": ("kmer_front", (_P, _P, _P, _I, _I, _I, _I, _P), "kmer_bins"),
    "kmer_bins_packed": ("kmer_front", (_P, _P, _P, _I, _I, _I, _I, _P), "kmer_bins"),
    # packed codes, packed flags, lengths, keys, vals, vals_dense, offsets,
    # taxon, taxon_dense (read and written in place), B, LB, W, k, nt,
    # n_keys, n_bins, n_iter, bin_start, first, stream: one database's
    # binary search of the lanes still 0, bins and k-mers from the words
    "bsearch_words": ("bsearch_lookup", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _I,
                                         _L, _I, _P), "bsearch_words"),
}
# card records of one launch of an entry point that puts several on the
# stream: sparse_stats' decide and emit kernels; span_dict's bitmap clear
# (a memset) and its mark, scan and remap kernels
RECORDS_PER_LAUNCH = {"sparse_stats": 2, "span_dict": 4}

LAUNCHES = {name: 0 for name in (*SIGNATURES, *(counter for _, _, counter in ENTRIES.values()))}
_libs: dict = {}  # name -> the loaded library
_fns: dict = {}  # symbol -> a loaded entry point, argtypes bound
_sms: dict = {}  # device index -> its SM count


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _lib_path(name: str) -> str:
    """The library of csrc/<name>.cu, named by a digest of the source, the
    csrc/ headers it includes and the flags."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src)
    for header in sorted(set(_INCLUDE.findall(src))):
        with open(os.path.join(CSRC, header.decode()), "rb") as f:
            h.update(header + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per source, all started together. Returns name -> path
    of the shared library; raises with nvcc's output if any build fails."""
    names = list(SIGNATURES if names is None else names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, proc) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def entry(name: str, symbol: str, argtypes):
    """The C function `symbol` of kernel `name`'s library (built on first
    use), its argtypes bound and returning an int. `launch` calls the
    kernel's own `kuniq_<name>`; a library's other entry points (one that
    reports a launch's geometry, say) launch nothing and count nothing."""
    fn = _fns.get(symbol)
    if fn is None:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build([name])[name])
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def check_cuda(name: str, **tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device and contiguous; returns the device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {dev}")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dev


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` (a library or an `ENTRIES` entry point) on
    `device`'s current stream; tensors in `args` are passed by data
    pointer, None as NULL. Raises on a refused launch. Enters the device's
    context only when another device is current."""
    lib, sig, counter = ENTRIES.get(name, (name, SIGNATURES.get(name), name))
    fn = entry(lib, f"kuniq_{name}", sig)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        rc = fn(*c_args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*c_args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[counter] += 1
