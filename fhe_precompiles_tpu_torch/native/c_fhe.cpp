// C ABI shim: the 51-symbol extern-C precompile surface of the port.
//
// The port's counterpart of fhe_precompiles_tpu/native/c_fhe.cpp.  Parity
// target: the reference's src/c_fhe.rs -- 49 precompile entry points
// (generated by its create_c_precompile_function! macro, c_fhe.rs:8-59)
// plus fhe_free (c_fhe.rs:61-64) and fhe_error (c_fhe.rs:66-71).  Same
// signatures, same error-code contract (0 = success, codes 1-7 from
// lib.rs:14-27), same malloc'd-output ownership rules.
//
// The compute path is the port's Python runtime, reached through an
// embedded CPython interpreter (initialized at the first call, thread-safe
// through the GIL): every call goes to
// fhe_precompiles_tpu_torch.native._abi_call, which runs the app that
// native.use_app named, by default testnet.one.FHE (the torch engine on the
// card).  Loaded into a running interpreter (ctypes), the shim uses that
// interpreter.

#include <Python.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

#include "c_fhe.h"  // the public 51-symbol surface (prototypes + X-macro)

namespace {

constexpr int32_t kErrInvalidEncoding = 3;  // lib.rs:20
constexpr int32_t kErrRuntime = 7;          // lib.rs:24 (SunscreenError)

PyObject *g_call = nullptr;  // fhe_precompiles_tpu_torch.native._abi_call
std::once_flag g_init_flag;
bool g_init_ok = false;

// Put the repository root (three components above this library:
// libc_fhe.so, _build/, the package directory) on sys.path, so that the
// embedded interpreter imports the package wherever the host process runs.
void add_package_root_to_sys_path() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void *>(&add_package_root_to_sys_path), &info) ==
          0 ||
      info.dli_fname == nullptr) {
    return;
  }
  std::string path(info.dli_fname);
  for (int i = 0; i < 3; ++i) {  // strip libc_fhe.so, _build/, package dir
    size_t slash = path.find_last_of('/');
    if (slash == std::string::npos) return;
    path.erase(slash);
  }
  PyObject *sys_path = PySys_GetObject("path");  // borrowed
  PyObject *entry = PyUnicode_FromString(path.c_str());
  if (sys_path != nullptr && entry != nullptr) {
    PyList_Append(sys_path, entry);
  }
  Py_XDECREF(entry);
}

void initialize_runtime() {
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  add_package_root_to_sys_path();
  PyObject *mod = PyImport_ImportModule("fhe_precompiles_tpu_torch.native");
  if (mod != nullptr) {
    g_call = PyObject_GetAttrString(mod, "_abi_call");
    Py_DECREF(mod);
  }
  if (g_call == nullptr) {
    PyErr_Print();
  } else {
    g_init_ok = true;
  }
  PyGILState_Release(gil);
  if (we_initialized) {
    // Release the GIL that Py_InitializeEx left with this thread, so that
    // OTHER host threads can enter through PyGILState_Ensure (otherwise the
    // first caller returns to host code still holding the GIL and every
    // other thread deadlocks).
    PyEval_SaveThread();
  }
}

// Shared implementation for every precompile entry point.
int32_t run_precompile(const char *name, const uint8_t *bytes,
                       size_t bytes_length, uint8_t **output,
                       int64_t *output_length) {
  if (output == nullptr || output_length == nullptr) {
    return kErrInvalidEncoding;
  }
  *output = nullptr;
  *output_length = 0;

  std::call_once(g_init_flag, initialize_runtime);
  if (!g_init_ok) {
    return kErrRuntime;
  }

  PyGILState_STATE gil = PyGILState_Ensure();
  int32_t code = kErrRuntime;
  PyObject *arg_bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(bytes),
      static_cast<Py_ssize_t>(bytes_length));
  if (arg_bytes != nullptr) {
    PyObject *res = PyObject_CallFunction(g_call, "sO", name, arg_bytes);
    Py_DECREF(arg_bytes);
    if (res != nullptr && PyTuple_Check(res) && PyTuple_GET_SIZE(res) == 2) {
      PyObject *py_code = PyTuple_GET_ITEM(res, 0);
      PyObject *py_payload = PyTuple_GET_ITEM(res, 1);
      long c = PyLong_AsLong(py_code);
      if (c == 0 && PyBytes_Check(py_payload)) {
        Py_ssize_t len = PyBytes_GET_SIZE(py_payload);
        uint8_t *buf = static_cast<uint8_t *>(std::malloc(
            static_cast<size_t>(len) > 0 ? static_cast<size_t>(len) : 1));
        if (buf != nullptr) {
          std::memcpy(buf, PyBytes_AS_STRING(py_payload),
                      static_cast<size_t>(len));
          *output = buf;
          *output_length = static_cast<int64_t>(len);
          code = 0;
        }
      } else if (c > 0) {
        code = static_cast<int32_t>(c);
      }
      if (PyErr_Occurred()) {
        PyErr_Print();
        code = kErrRuntime;
      }
    } else {
      PyErr_Print();
    }
    Py_XDECREF(res);
  }
  PyGILState_Release(gil);
  return code;
}

}  // namespace

extern "C" {

// fhe_free (c_fhe.rs:61-64): release a buffer returned by any precompile.
void fhe_free(const uint8_t *bytes) {
  std::free(const_cast<uint8_t *>(bytes));
}

// fhe_error (c_fhe.rs:66-71): error code -> malloc'd C string.
const char *fhe_error(int32_t error_code) {
  const char *msg;
  switch (error_code) {  // strings: lib.rs:33-44
    case 1: msg = "Unexpected end of file"; break;
    case 2: msg = "Platform architecture invalid"; break;
    case 3: msg = "Invalid encoding"; break;
    case 4: msg = "Overflow in FHE program"; break;
    case 5: msg = "Invalid decryption"; break;
    case 6: msg = "Invalid encryption"; break;
    case 7: msg = "Base sunscreen error"; break;
    default: msg = "Unknown error"; break;
  }
  size_t len = std::strlen(msg) + 1;
  char *out = static_cast<char *>(std::malloc(len));
  if (out != nullptr) {
    std::memcpy(out, msg, len);
  }
  return out;
}

// The 49 precompiles in the reference's declaration order come from the
// public header's FHE_PRECOMPILE_LIST X-macro (c_fhe.h, c_fhe.rs:74-141).
#define DEFINE_C_PRECOMPILE(name)                                       \
  int32_t c_fhe_##name(const uint8_t *bytes, size_t bytes_length,       \
                       uint8_t **output, int64_t *output_length) {      \
    return run_precompile(#name, bytes, bytes_length, output,           \
                          output_length);                               \
  }

FHE_PRECOMPILE_LIST(DEFINE_C_PRECOMPILE)

#undef DEFINE_C_PRECOMPILE

}  // extern "C"
