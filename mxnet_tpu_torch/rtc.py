"""``mx.rtc``: user CUDA kernels compiled at run time with NVRTC.

The reference MXNet's ``mx.rtc.CudaModule`` / ``CudaKernel``, the name the
JAX package reserves (``mxnet_tpu/rtc.py:181``).  It replaces the JAX
package's TPU user-kernel runtime, ``PallasKernel._build``
(``mxnet_tpu/rtc.py:109``), which compiles a Pallas kernel per (shapes,
dtypes, grid, specs) and launches it on NDArrays.  Here the kernel
language is the card's own:

    import mxnet_tpu_torch as mx
    src = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha,
                                    int n) {
        int i = blockIdx.x * blockDim.x + threadIdx.x;
        if (i < n) y[i] = alpha * x[i] + y[i];
    }'''
    mod = mx.rtc.CudaModule(src)
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha, int n")
    k.launch([x, y, 2.0, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
             (256, 1, 1))

* **Build.**  ``CudaModule`` compiles its source once with NVRTC for
  ``sm_90a`` (Hopper) and keeps the CUBIN, not PTX: a CUBIN needs no JIT
  in the driver, so an NVRTC newer than the driver cannot break the load.
  The driver API loads it once per card into the card's primary context
  (retained, and made current on the launching thread: torch's runtime
  calls may leave no current context on it).  A kernel is looked up once
  per (card, name).  Names that are not ``extern "C"`` go in ``exports``
  and are resolved through ``nvrtcGetLoweredName``.
* **Launch.**  ``CudaKernel.launch`` writes into the NDArrays it is given,
  as the reference does, on the card's current torch stream, so it is
  ordered with the torch work around it.  It does not synchronise: a
  fault inside the kernel surfaces at the next sync point (``asnumpy``,
  ``wait_to_read``, ``waitall``).  A pointer argument must be a
  contiguous NDArray on the launch context with exactly the signature's
  type; a scalar is packed as its C type.  A context that is not a GPU
  raises: there is no CPU path.
* **Libraries.**  ``libnvrtc`` is searched under ``$CUDA_HOME/lib64``,
  ``/usr/local/cuda/lib64``, then the ``nvidia/cuda_nvrtc/lib`` that
  PyTorch's wheel ships; its ``libnvrtc-builtins`` is loaded first from
  the same directory with ``RTLD_GLOBAL``, since NVRTC opens it by soname.
  ``libcuda.so.1`` comes from the driver.  A missing one raises
  ``MXNetError`` naming it.

What bounds a user kernel is the user's code; the runtime's own cost is
host time per launch (argument checks and packing, one driver call).
``rtc_launches`` counts the launches.  The Triton-function counterpart of
the JAX package's ``PallasModule`` is not ported (ROADMAP queue 2).
"""
from __future__ import annotations

import ctypes
import glob
import os
import re
import site
import sys
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .base import MXNetError, numeric_types
from .context import Context

__all__ = ["CudaModule", "CudaKernel", "rtc_launches"]

# launches of user kernels since the last reset (chip_smoke sets it to 0)
rtc_launches = 0

# C type in a signature -> (torch dtype of a pointer argument, ctypes type
# of a scalar argument)
_CTYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
    "int8_t": (torch.int8, ctypes.c_int8),
    "char": (torch.int8, ctypes.c_int8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
}

_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

ARCH = "sm_90a"
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_STATIC_SMEM_LIMIT = 48 * 1024


def _parse_signature(signature: str) -> List[Tuple[bool, bool, str]]:
    """``[(is_pointer, is_const, ctype), ...]`` for a C parameter list
    such as ``"const float *x, float *y, float alpha, int n"``."""
    out = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise MXNetError(f'invalid kernel argument "{arg.strip()}": '
                             'must be of the form "(const) type (*) (name)"')
        if m.group(2) not in _CTYPES:
            raise MXNetError(f'unsupported kernel argument type in '
                             f'"{arg.strip()}"; supported: '
                             f'{", ".join(_CTYPES)}')
        out.append((bool(m.group(3)), bool(m.group(1)), m.group(2)))
    return out


# ---------------------------------------------------------------------------
# the two libraries
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvrtc_dirs() -> List[str]:
    dirs = []
    home = os.environ.get("CUDA_HOME")
    if home:
        dirs.append(os.path.join(home, "lib64"))
    dirs.append("/usr/local/cuda/lib64")
    roots = list(sys.path)
    try:
        roots += site.getsitepackages()
    except AttributeError:
        pass
    dirs += [os.path.join(r, "nvidia", "cuda_nvrtc", "lib") for r in roots]
    return dirs


def _find_nvrtc() -> str:
    for d in _nvrtc_dirs():
        found = sorted(glob.glob(os.path.join(d, "libnvrtc.so*")), key=len)
        if found:
            return found[0]
    raise MXNetError("libnvrtc.so not found (looked in $CUDA_HOME/lib64, "
                     "/usr/local/cuda/lib64 and nvidia/cuda_nvrtc/lib of "
                     "the Python path): mx.rtc compiles with NVRTC")


def _declare(lib, table):
    for name, (argtypes, restype) in table.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_STR = ctypes.c_char_p
_STRS = ctypes.POINTER(ctypes.c_char_p)
_BUF = ctypes.POINTER(ctypes.c_char)
_SIZE = ctypes.POINTER(ctypes.c_size_t)
_INT = ctypes.c_int
_UINT = ctypes.c_uint

_NVRTC_API = {
    "nvrtcCreateProgram": ([_PP, _STR, _STR, _INT, _STRS, _STRS], _INT),
    "nvrtcAddNameExpression": ([_P, _STR], _INT),
    "nvrtcCompileProgram": ([_P, _INT, _STRS], _INT),
    "nvrtcGetProgramLogSize": ([_P, _SIZE], _INT),
    "nvrtcGetProgramLog": ([_P, _BUF], _INT),
    "nvrtcGetCUBINSize": ([_P, _SIZE], _INT),
    "nvrtcGetCUBIN": ([_P, _BUF], _INT),
    "nvrtcGetLoweredName": ([_P, _STR, _STRS], _INT),
    "nvrtcDestroyProgram": ([_PP], _INT),
    "nvrtcGetErrorString": ([_INT], _STR),
    "nvrtcVersion": ([ctypes.POINTER(_INT), ctypes.POINTER(_INT)], _INT),
}

_CUDA_API = {
    "cuInit": ([_UINT], _INT),
    "cuDeviceGet": ([ctypes.POINTER(_INT), _INT], _INT),
    "cuDevicePrimaryCtxRetain": ([_PP, _INT], _INT),
    "cuCtxSetCurrent": ([_P], _INT),
    "cuModuleLoadData": ([_PP, _P], _INT),
    "cuModuleGetFunction": ([_PP, _P, _STR], _INT),
    "cuFuncSetAttribute": ([_P, _INT, _INT], _INT),
    "cuLaunchKernel": ([_P, _UINT, _UINT, _UINT, _UINT, _UINT, _UINT, _UINT,
                        _P, _PP, _PP], _INT),
    "cuGetErrorName": ([_INT, _STRS], _INT),
    "cuGetErrorString": ([_INT, _STRS], _INT),
}


def _nvrtc() -> ctypes.CDLL:
    with _lock:
        lib = _libs.get("nvrtc")
        if lib is None:
            path = _find_nvrtc()
            builtins = sorted(glob.glob(os.path.join(
                os.path.dirname(path), "libnvrtc-builtins.so*")), key=len)
            if builtins:
                ctypes.CDLL(builtins[0], mode=ctypes.RTLD_GLOBAL)
            lib = _libs["nvrtc"] = _declare(ctypes.CDLL(path), _NVRTC_API)
        return lib


def _cuda() -> ctypes.CDLL:
    with _lock:
        lib = _libs.get("cuda")
        if lib is None:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise MXNetError(f"libcuda.so.1 (the CUDA driver) could not "
                                 f"be loaded: {e}") from None
            _declare(lib, _CUDA_API)
            _check_cu(lib, lib.cuInit(0), "cuInit")
            _libs["cuda"] = lib
        return lib


def _check_nvrtc(lib, res, what):
    if res != 0:
        raise MXNetError(f"{what} failed: "
                         f"{lib.nvrtcGetErrorString(res).decode()}")


def _check_cu(lib, res, what):
    if res != 0:
        name, text = ctypes.c_char_p(), ctypes.c_char_p()
        lib.cuGetErrorName(res, ctypes.byref(name))
        lib.cuGetErrorString(res, ctypes.byref(text))
        raise MXNetError(f"{what} failed: {res} "
                         f"{(name.value or b'?').decode()}: "
                         f"{(text.value or b'').decode()}")


def nvrtc_version() -> Tuple[int, int]:
    """NVRTC's (major, minor)."""
    lib = _nvrtc()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _check_nvrtc(lib, lib.nvrtcVersion(ctypes.byref(major),
                                       ctypes.byref(minor)), "nvrtcVersion")
    return major.value, minor.value


def _include_dirs() -> List[str]:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    inc = os.path.join(home, "include")
    return [inc] if os.path.isdir(inc) else []


def _compile(source: str, options: Sequence[str],
             exports: Sequence[str]) -> Tuple[bytes, Dict[str, str]]:
    """NVRTC: ``source`` to a CUBIN, and each export's lowered name.
    Raises ``MXNetError`` with NVRTC's log on a compile error."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"mx_rtc.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for name in exports:
            _check_nvrtc(lib, lib.nvrtcAddNameExpression(
                prog, name.encode()), f"nvrtcAddNameExpression({name})")
        opts = list(options)
        if not any(o.startswith(("-arch", "--gpu-architecture"))
                   for o in opts):
            opts.insert(0, f"--gpu-architecture={ARCH}")
        opts += [f"-I{d}" for d in _include_dirs()]
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        res = lib.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, log)
        if res != 0:
            raise MXNetError(
                f"NVRTC compile failed "
                f"({lib.nvrtcGetErrorString(res).decode()}):\n"
                f"{log.value.decode(errors='replace')}")
        _check_nvrtc(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            _check_nvrtc(lib, lib.nvrtcGetLoweredName(
                prog, name.encode(), ctypes.byref(out)),
                f"nvrtcGetLoweredName({name})")
            lowered[name] = out.value.decode()
        return cubin.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


_primary: Dict[int, ctypes.c_void_p] = {}


def _current_context(lib, device_id: int):
    """Make card ``device_id``'s primary context (the one torch uses)
    current on this thread; retained once for the process's life."""
    ctx = _primary.get(device_id)
    if ctx is None:
        dev = ctypes.c_int()
        _check_cu(lib, lib.cuDeviceGet(ctypes.byref(dev), device_id),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _check_cu(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                  "cuDevicePrimaryCtxRetain")
        _primary[device_id] = ctx
    _check_cu(lib, lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


def _load_function(cubin: bytes, device_id: int, modules: dict,
                   name: str) -> ctypes.c_void_p:
    """The kernel ``name`` of ``cubin`` on card ``device_id``; the module
    is loaded into ``modules`` once per card."""
    lib = _cuda()
    torch.cuda.init()
    _current_context(lib, device_id)
    mod = modules.get(device_id)
    if mod is None:
        mod = ctypes.c_void_p()
        _check_cu(lib, lib.cuModuleLoadData(ctypes.byref(mod), cubin),
                  "cuModuleLoadData")
        modules[device_id] = mod
    fn = ctypes.c_void_p()
    res = lib.cuModuleGetFunction(ctypes.byref(fn), mod, name.encode())
    if res != 0:
        raise MXNetError(f"kernel {name!r} is not in the module (an "
                         "un-mangled name needs extern \"C\" or exports=)")
    return fn


# ---------------------------------------------------------------------------
# the user surface
# ---------------------------------------------------------------------------


class CudaModule:
    """CUDA source compiled once with NVRTC (parity: mx.rtc.CudaModule).

    Args:
      source: CUDA C++ source of one or more ``__global__`` kernels.
      options: extra NVRTC options (``--gpu-architecture=sm_90a`` is
        added unless one is given).
      exports: name expressions of kernels that are not ``extern "C"``
        (templates, overloads), e.g. ``"fill<float>"``.
    """

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not isinstance(source, str):
            raise MXNetError("CudaModule takes CUDA source as a string")
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self._cubin, self._lowered = _compile(source, self.options,
                                              self.exports)
        self._modules: Dict[int, ctypes.c_void_p] = {}
        self._functions: Dict[Tuple[int, str], ctypes.c_void_p] = {}

    @property
    def cubin_bytes(self) -> int:
        return len(self._cubin)

    def _function(self, device_id: int, name: str) -> ctypes.c_void_p:
        key = (device_id, name)
        fn = self._functions.get(key)
        if fn is None:
            fn = self._functions[key] = _load_function(
                self._cubin, device_id, self._modules, name)
        return fn

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` with its C parameter list ``signature``;
        raises ``MXNetError`` when the module has no such kernel."""
        lowered = self._lowered.get(name, name)
        if not torch.cuda.is_available():
            raise MXNetError("CudaModule.get_kernel needs a CUDA device, "
                             "but none is available")
        self._function(torch.cuda.current_device(), lowered)
        return CudaKernel(self, name, lowered, signature)


class CudaKernel:
    """A kernel of a ``CudaModule`` (parity: mx.rtc.CudaKernel)."""

    def __init__(self, module: CudaModule, name: str, lowered: str,
                 signature: str):
        self._module = module
        self._name = name
        self._lowered = lowered
        self._args = _parse_signature(signature)
        self._shared_set = 0

    def _check_args(self, args, device: torch.device) -> list:
        """Each argument as a ctypes value, after the checks: a pointer is
        a contiguous NDArray on ``device`` of exactly its type; a scalar
        is a number."""
        from .ndarray.ndarray import NDArray
        if len(args) != len(self._args):
            raise MXNetError(f"kernel {self._name!r} takes "
                             f"{len(self._args)} arguments, got {len(args)}")
        values = []
        for i, (arg, (is_ptr, _, ctype)) in enumerate(zip(args, self._args)):
            dtype, cty = _CTYPES[ctype]
            if is_ptr:
                if not isinstance(arg, NDArray):
                    raise MXNetError(f"argument {i} of {self._name!r} must "
                                     f"be an NDArray, got "
                                     f"{type(arg).__name__}")
                t = arg._t
                if t.device != device:
                    raise MXNetError(f"argument {i} of {self._name!r} is on "
                                     f"{arg.context}, the launch on "
                                     f"{device}")
                if t.dtype != dtype:
                    raise MXNetError(f"argument {i} of {self._name!r} is "
                                     f"{t.dtype}, the signature says "
                                     f"{ctype} ({dtype})")
                if not t.is_contiguous():
                    raise MXNetError(f"argument {i} of {self._name!r} is "
                                     "not contiguous")
                values.append(ctypes.c_void_p(t.data_ptr()))
            else:
                if not isinstance(arg, numeric_types) or isinstance(
                        arg, (bool, np.bool_)):
                    raise MXNetError(f"argument {i} of {self._name!r} must "
                                     f"be a number, got "
                                     f"{type(arg).__name__}")
                if ctype == "__half":
                    values.append(cty(int(np.float16(arg).view(np.uint16))))
                else:
                    values.append(cty(arg))
        return values

    def launch(self, args, ctx: Context, grid_dims, block_dims,
               shared_mem: int = 0):
        """Launch on ``ctx`` (a GPU context) with ``grid_dims`` and
        ``block_dims`` (3 ints each) and ``shared_mem`` bytes of dynamic
        shared memory, on the card's current stream.  Writes into the
        NDArrays in ``args``; does not wait for the kernel."""
        global rtc_launches
        if not isinstance(ctx, Context) or ctx.device_type != "gpu":
            raise MXNetError(f"CudaKernel.launch needs a GPU context, got "
                             f"{ctx}: user CUDA kernels have no CPU path")
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise MXNetError("grid_dims and block_dims must be 3 ints each")
        device = ctx.device
        values = self._check_args(args, device)
        fn = self._module._function(ctx.device_id, self._lowered)
        lib = _cuda()
        _current_context(lib, ctx.device_id)
        if shared_mem > _STATIC_SMEM_LIMIT and shared_mem > self._shared_set:
            _check_cu(lib, lib.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                int(shared_mem)), "cuFuncSetAttribute")
            self._shared_set = int(shared_mem)
        params = (ctypes.c_void_p * max(len(values), 1))(
            *[ctypes.addressof(v) for v in values])
        stream = torch.cuda.current_stream(device).cuda_stream
        # ``values`` holds every argument alive through the call
        _check_cu(lib, lib.cuLaunchKernel(
            fn, *(int(g) for g in grid_dims), *(int(b) for b in block_dims),
            int(shared_mem), ctypes.c_void_p(stream), params, None),
            f"cuLaunchKernel({self._name})")
        rtc_launches += 1
