"""Build several copies of one CUDA source side by side, for the tools that
time them (``ssd_scan_variants.py``, ``flash_bwd_variants.py``)."""
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_variants(argv, default_src, keep):
    """Build each NAME=[SOURCE][:FLAGS] of ``argv`` (SOURCE defaults to
    ``default_src``; its ``#include "..."`` also resolves in the port's
    csrc/) with the port's nvcc flags plus FLAGS into
    build/variants/NAME.so, all at once; print each build's ptxas report
    of the entry functions ``keep(name)`` selects and the build time.
    Returns {NAME: loaded library}, or None after printing a failed
    build's log."""
    import chip_smoke as cs
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for arg in argv:
        name, _, spec = arg.partition("=")
        src, _, flags = spec.partition(":")
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
               *flags.split(), "-o", lib, src or default_src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"build of {name} failed:\n{log}", file=sys.stderr)
            return None
        ptxas = {k: v for k, v in cs.ptxas_by_kernel(log).items() if keep(k)}
        print(json.dumps({"build": name, "ptxas": ptxas}), flush=True)
        libs[name] = ctypes.CDLL(lib)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    return libs
