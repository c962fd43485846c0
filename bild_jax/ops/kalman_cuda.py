"""
Rouse-Kalman likelihood as a CUDA kernel (``kalman_cuda.cu``), called
through JAX's foreign function interface: the float32 path on a GPU.

The XLA scan (`ops.kalman.msrouse_logL_batch`) carries the whole
``(P, q, N, N)`` covariance batch through device memory on every frame and
propagates every profile through every state. The kernel instead keeps one
profile's covariance and mean on chip (one warp per profile, one lane per
covariance row) for the whole frame loop, and applies only the profile's own
state per frame. Same arguments, same semantics (NaN for out-of-range
states), same float32 arithmetic at full precision.

The library is compiled from the source in this directory with ``nvcc`` on
first use, once per ``(N, d)`` (both are compile-time constants of the
kernel), into ``build/`` at the checkout root. A GPU without ``nvcc`` raises
instead of falling back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
from jax.experimental.custom_partitioning import custom_partitioning
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ["msrouse_logL_cuda"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "kalman_cuda.cu")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_N = 32      # one warp lane per covariance row

_targets = {}   # (N, d) -> (registered FFI target name, loaded library)
_calls = {}     # (N, d) -> batched, partitioned JAX callable


def _nvcc():
    """``nvcc`` on PATH, else in the toolkit at ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"the CUDA Rouse-Kalman kernel needs nvcc (CUDA "
                           f"toolkit) to build; none found on PATH or in "
                           f"{home}/bin (set CUDA_HOME)")
    return nvcc


def build_library(N: int, d: int) -> str:
    """Compile the kernel for ``(N, d)`` unless a build of the current
    source exists; returns the shared library's path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + repr(_NVCC_FLAGS).encode())
    so = os.path.join(_BUILD, f"rouse_kalman_n{N}_d{d}_"
                              f"{digest.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, f"-DBILD_N={N}", f"-DBILD_D={d}",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"building the CUDA Rouse-Kalman kernel failed "
                           f"({' '.join(cmd)}):\n{p.stderr}")
    os.replace(tmp, so)
    return so


def _target(N: int, d: int) -> str:
    if (N, d) not in _targets:
        if not 1 <= N <= MAX_N:
            raise ValueError(f"the CUDA Rouse-Kalman kernel holds one "
                             f"covariance row per warp lane: N <= {MAX_N}, "
                             f"got N={N}")
        lib = ctypes.cdll.LoadLibrary(build_library(N, d))
        name = f"bild_rouse_kalman_n{N}_d{d}"
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(lib.BildRouseKalmanF32), platform="CUDA")
        _targets[N, d] = name, lib
    return _targets[N, d][0]


def _ffi(N, d, out_shape):
    """The kernel as a JAX callable on arguments that all carry the same
    leading batch dims; it runs one run of blocks per batch element."""
    return jax.ffi.ffi_call(_target(N, d),
                            jax.ShapeDtypeStruct(out_shape, jnp.float32))


# argument 8 is ``profiles``; every argument's factors after the shared
# leading batch dims ``...`` (Shardy notation)
_RULE = ("... n i j, ... n i d, ... n i j, ... n i d, ... n i j, ... i, "
         "... q, ... d, ... p t, ... t d, ... t -> ... p")


def _call(N, d):
    """The kernel for ``(N, d)`` as a JAX function that ``vmap`` (over
    trajectories, and over k in the fused runners) and a device mesh both
    split: each vmap level adds a leading batch dim to every argument, and
    on a mesh every device runs the kernel on its own batch rows (and
    profile columns) instead of all-gathering them."""
    if (N, d) in _calls:
        return _calls[N, d]

    def run(*args):
        return _ffi(N, d, args[8].shape[:-1])(*args)

    def shardings(mesh, arg_shapes):
        prof = arg_shapes[8]
        lead = len(prof.shape) - 2
        spec = tuple(prof.sharding.spec) + (None,) * len(prof.shape)
        lead_spec, p_spec = spec[:lead], spec[lead]
        args = [NamedSharding(mesh, P(*lead_spec,
                                      *(None,) * (len(a.shape) - lead)))
                for a in arg_shapes]
        args[8] = NamedSharding(mesh, P(*lead_spec, p_spec, None))
        return args, NamedSharding(mesh, P(*lead_spec, p_spec))

    def partition(mesh, arg_shapes, result_shape):
        args, out = shardings(mesh, arg_shapes)
        return mesh, run, out, tuple(args)

    part = custom_partitioning(run)
    part.def_partition(
        partition=partition,
        infer_sharding_from_operands=lambda mesh, a, r: shardings(mesh, a)[1],
        sharding_rule=_RULE,
        need_replication_factors=("n", "i", "j", "d", "q", "t"))

    @jax.custom_batching.custom_vmap
    def batched(*args):
        return part(*args)

    @batched.def_vmap
    def _(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size,) + a.shape)
                for a, b in zip(args, in_batched)]
        return batched(*args), True

    _calls[N, d] = batched
    return batched


def msrouse_logL_cuda(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                      profiles, ydata, valid):
    """`ops.kalman.msrouse_logL_batch` on the CUDA kernel (float32).

    Shapes as there: ``Bs, Sigs, C0s`` (n, N, N), ``Gs, M0s`` (n, N, d),
    ``w`` (N,), ``s2`` (q,), ``Cind`` (d,), ``profiles`` (P, T),
    ``ydata`` (T, d), ``valid`` (T,). Returns (P,) float32.
    """
    f32 = jnp.float32
    profiles = jnp.asarray(profiles, jnp.int32)
    N, d = Bs.shape[-1], Gs.shape[-1]
    return _call(N, d)(*(jnp.asarray(a, f32) for a in (Bs, Gs, Sigs, M0s,
                                                       C0s, w, s2)),
                jnp.asarray(Cind, jnp.int32), profiles,
                jnp.asarray(ydata, f32), jnp.asarray(valid, jnp.int32))
