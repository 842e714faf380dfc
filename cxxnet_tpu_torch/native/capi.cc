/*
 * C ABI of the PyTorch port: embeds CPython and dispatches to
 * cxxnet_tpu_torch.wrapper.api.  It implements every function that
 * native/capi.h declares (the header is shared, so the ABI is the same as
 * native/capi.cc's over the JAX package); cxxnet_tpu_torch/native/build.py
 * compiles it with -I native.
 *
 * Reference analogue: wrapper/cxxnet_wrapper.cpp wraps the C++ trainer in
 * extern "C"; here the trainer lives in Python (torch), so the shim runs the
 * interpreter in-process.  When loaded INTO a Python process (ctypes), the
 * existing interpreter is reused; from a plain C/C++ host the interpreter is
 * initialised on first use and finds torch and the repo on its sys.path
 * (PYTHONPATH), as native/capi.cc finds the JAX package.
 */
#include "capi.h"

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

std::string g_last_error;
bool g_shutdown = false;

/* python helper functions, defined once in a private dict */
const char *kHelperSrc = R"PY(
import numpy as np
from cxxnet_tpu_torch.wrapper.api import Net, DataIter

def _arr(mv, shape):
    return np.frombuffer(mv, dtype=np.float32).reshape(shape)

def _c(a):
    return np.ascontiguousarray(a, np.float32)

def net_create(dev, cfg):
    return Net(dev=dev, cfg=cfg)

def net_update_batch(net, data, dshape, label, lshape):
    net.update(_arr(data, dshape), _arr(label, lshape))

def net_predict(net, data, dshape):
    return _c(net.predict(_arr(data, dshape)))

def net_extract(net, data, dshape, node):
    return _c(net.extract(_arr(data, dshape), node))

def _iter_map(it, fn):
    outs = []
    it.before_first()
    while it.next():
        outs.append(fn(it))
    return _c(np.concatenate(outs, axis=0))

def net_predict_iter(net, it):
    return _iter_map(it, net.predict)

def net_extract_iter(net, it, node):
    return _iter_map(it, lambda v: net.extract(v, node))

def net_get_weight(net, layer, tag):
    w = net.get_weight(layer, tag)
    return None if w is None else _c(w)

def net_set_weight(net, buf, size, layer, tag):
    w = net.get_weight(layer, tag)
    if w is None:
        raise KeyError(f"no weight {layer}:{tag}")
    net.set_weight(np.frombuffer(buf, np.float32, count=size).reshape(w.shape),
                   layer, tag)

def io_create(cfg):
    return DataIter(cfg)

def run_task(args):
    from cxxnet_tpu_torch.main import LearnTask
    return LearnTask().run(list(args))

def io_get_data(it):
    return _c(it.get_data())

def io_get_label(it):
    return _c(it.get_label())
)PY";

PyObject *g_helpers = nullptr; /* dict holding the helper functions */

struct Handle {
  PyObject *obj = nullptr; /* Net or DataIter */
  Py_buffer buf{};         /* last returned array, owned */
  bool has_buf = false;
  std::vector<cxx_ulong> shape;
  std::string str_out;
};

void set_error_from_python() {
  PyObject *ptype = nullptr, *pvalue = nullptr, *ptb = nullptr;
  PyErr_Fetch(&ptype, &pvalue, &ptb);
  PyErr_NormalizeException(&ptype, &pvalue, &ptb);
  g_last_error = "python error";
  if (pvalue) {
    PyObject *s = PyObject_Str(pvalue);
    if (s) {
      g_last_error = PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(ptype);
  Py_XDECREF(pvalue);
  Py_XDECREF(ptb);
}

bool g_we_initialized = false;

bool ensure_init() {
  static std::once_flag once;
  static bool ok = false;
  std::call_once(once, [] {
    if (!Py_IsInitialized()) {
      g_we_initialized = true;
      Py_InitializeEx(0);
      /* release the GIL taken by Py_Initialize; every entry point below
         re-acquires via PyGILState_Ensure */
      PyEval_SaveThread();
    }
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *globals = PyDict_New();
    PyDict_SetItemString(globals, "__builtins__", PyEval_GetBuiltins());
    PyObject *r =
        PyRun_String(kHelperSrc, Py_file_input, globals, globals);
    if (r == nullptr) {
      set_error_from_python();
      Py_DECREF(globals);
    } else {
      Py_DECREF(r);
      g_helpers = globals;
      ok = true;
    }
    PyGILState_Release(st);
  });
  if (!ok && g_last_error.empty())
    g_last_error = "interpreter init failed";
  return ok;
}

/* call helper fn with already-built args tuple; returns new ref or null */
PyObject *call_helper(const char *fn, PyObject *args) {
  PyObject *f = PyDict_GetItemString(g_helpers, fn); /* borrowed */
  if (f == nullptr) {
    g_last_error = std::string("missing helper ") + fn;
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *r = PyObject_CallObject(f, args);
  Py_XDECREF(args);
  if (r == nullptr) set_error_from_python();
  return r;
}

PyObject *mem_ro(const void *p, Py_ssize_t nbytes) {
  return PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<void *>(p)), nbytes, PyBUF_READ);
}

PyObject *shape_tuple(const cxx_ulong *shape, int ndim) {
  PyObject *t = PyTuple_New(ndim);
  for (int i = 0; i < ndim; ++i)
    PyTuple_SET_ITEM(t, i, PyLong_FromUnsignedLongLong(shape[i]));
  return t;
}

cxx_ulong shape_elems(const cxx_ulong *shape, int ndim) {
  cxx_ulong n = 1;
  for (int i = 0; i < ndim; ++i) n *= shape[i];
  return n;
}

/* stash arr's buffer in the handle; fill out_shape/out_ndim; return data */
const cxx_real_t *return_array(Handle *h, PyObject *arr, cxx_ulong *out_shape,
                               int *out_ndim) {
  if (arr == nullptr) return nullptr;
  if (h->has_buf) {
    PyBuffer_Release(&h->buf);
    h->has_buf = false;
  }
  if (PyObject_GetBuffer(arr, &h->buf, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) !=
      0) {
    set_error_from_python();
    Py_DECREF(arr);
    return nullptr;
  }
  Py_DECREF(arr); /* h->buf keeps its own reference */
  h->has_buf = true;
  int nd = h->buf.ndim;
  if (out_ndim) *out_ndim = nd;
  if (out_shape)
    for (int i = 0; i < nd && i < 4; ++i)
      out_shape[i] = static_cast<cxx_ulong>(h->buf.shape[i]);
  return reinterpret_cast<const cxx_real_t *>(h->buf.buf);
}

struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

#define API_PROLOG(defval)                                  \
  if (g_shutdown) {                                           \
    g_last_error = "CXNShutdown was called; the library "     \
                   "cannot be used afterwards";               \
    return defval;                                            \
  }                                                           \
  if (!ensure_init()) return defval;                          \
  Gil gil_;

}  // namespace

extern "C" {

const char *CXNGetLastError(void) { return g_last_error.c_str(); }

void *CXNNetCreate(const char *device, const char *cfg) {
  API_PROLOG(nullptr);
  PyObject *r =
      call_helper("net_create", Py_BuildValue("(ss)", device, cfg));
  if (r == nullptr) return nullptr;
  Handle *h = new Handle();
  h->obj = r;
  return h;
}

void CXNNetFree(void *handle) {
  if (handle == nullptr) return;
  API_PROLOG();
  Handle *h = static_cast<Handle *>(handle);
  if (h->has_buf) PyBuffer_Release(&h->buf);
  Py_XDECREF(h->obj);
  delete h;
}

int CXNNetSetParam(void *handle, const char *name, const char *val) {
  API_PROLOG(-1);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = PyObject_CallMethod(h->obj, "set_param", "ss", name, val);
  if (r == nullptr) { set_error_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

static int method0(void *handle, const char *name) {
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = PyObject_CallMethod(h->obj, name, nullptr);
  if (r == nullptr) { set_error_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

static int method_s(void *handle, const char *name, const char *arg) {
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = PyObject_CallMethod(h->obj, name, "s", arg);
  if (r == nullptr) { set_error_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

int CXNNetInitModel(void *handle) {
  API_PROLOG(-1);
  return method0(handle, "init_model");
}
int CXNNetSaveModel(void *handle, const char *fname) {
  API_PROLOG(-1);
  return method_s(handle, "save_model", fname);
}
int CXNNetLoadModel(void *handle, const char *fname) {
  API_PROLOG(-1);
  return method_s(handle, "load_model", fname);
}
int CXNNetCopyModelFrom(void *handle, const char *fname) {
  API_PROLOG(-1);
  return method_s(handle, "copy_model_from", fname);
}
int CXNNetStartRound(void *handle, int round) {
  API_PROLOG(-1);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = PyObject_CallMethod(h->obj, "start_round", "i", round);
  if (r == nullptr) { set_error_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

int CXNNetUpdateBatch(void *handle, const cxx_real_t *data,
                      const cxx_ulong *dshape, int dndim,
                      const cxx_real_t *label, const cxx_ulong *lshape,
                      int lndim) {
  API_PROLOG(-1);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *args = Py_BuildValue(
      "(ONONO)", h->obj,
      mem_ro(data, sizeof(cxx_real_t) * shape_elems(dshape, dndim)),
      shape_tuple(dshape, dndim),
      mem_ro(label, sizeof(cxx_real_t) * shape_elems(lshape, lndim)),
      shape_tuple(lshape, lndim));
  PyObject *r = call_helper("net_update_batch", args);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

int CXNNetUpdateIter(void *handle, void *data_iter) {
  API_PROLOG(-1);
  Handle *h = static_cast<Handle *>(handle);
  Handle *it = static_cast<Handle *>(data_iter);
  PyObject *r = PyObject_CallMethod(h->obj, "update", "O", it->obj);
  if (r == nullptr) { set_error_from_python(); return -1; }
  Py_DECREF(r);
  return 0;
}

const cxx_real_t *CXNNetPredictBatch(void *handle, const cxx_real_t *data,
                                     const cxx_ulong *dshape, int dndim,
                                     cxx_ulong *out_shape, int *out_ndim) {
  API_PROLOG(nullptr);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *args = Py_BuildValue(
      "(ONO)", h->obj,
      mem_ro(data, sizeof(cxx_real_t) * shape_elems(dshape, dndim)),
      shape_tuple(dshape, dndim));
  return return_array(h, call_helper("net_predict", args), out_shape,
                      out_ndim);
}

const cxx_real_t *CXNNetPredictIter(void *handle, void *data_iter,
                                    cxx_ulong *out_shape, int *out_ndim) {
  API_PROLOG(nullptr);
  Handle *h = static_cast<Handle *>(handle);
  Handle *it = static_cast<Handle *>(data_iter);
  PyObject *args = Py_BuildValue("(OO)", h->obj, it->obj);
  return return_array(h, call_helper("net_predict_iter", args), out_shape,
                      out_ndim);
}

const cxx_real_t *CXNNetExtractBatch(void *handle, const cxx_real_t *data,
                                     const cxx_ulong *dshape, int dndim,
                                     const char *node_name,
                                     cxx_ulong *out_shape, int *out_ndim) {
  API_PROLOG(nullptr);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *args = Py_BuildValue(
      "(ONOs)", h->obj,
      mem_ro(data, sizeof(cxx_real_t) * shape_elems(dshape, dndim)),
      shape_tuple(dshape, dndim), node_name);
  return return_array(h, call_helper("net_extract", args), out_shape,
                      out_ndim);
}

const cxx_real_t *CXNNetExtractIter(void *handle, void *data_iter,
                                    const char *node_name,
                                    cxx_ulong *out_shape, int *out_ndim) {
  API_PROLOG(nullptr);
  Handle *h = static_cast<Handle *>(handle);
  Handle *it = static_cast<Handle *>(data_iter);
  PyObject *args = Py_BuildValue("(OOs)", h->obj, it->obj, node_name);
  return return_array(h, call_helper("net_extract_iter", args), out_shape,
                      out_ndim);
}

const char *CXNNetEvaluate(void *handle, void *data_iter, const char *name) {
  API_PROLOG(nullptr);
  Handle *h = static_cast<Handle *>(handle);
  Handle *it = static_cast<Handle *>(data_iter);
  PyObject *r =
      PyObject_CallMethod(h->obj, "evaluate", "Os", it->obj, name);
  if (r == nullptr) { set_error_from_python(); return nullptr; }
  const char *s = PyUnicode_AsUTF8(r);
  h->str_out = s ? s : "";
  Py_DECREF(r);
  return h->str_out.c_str();
}

const cxx_real_t *CXNNetGetWeight(void *handle, const char *layer_name,
                                  const char *tag, cxx_ulong *out_shape,
                                  int *out_ndim) {
  API_PROLOG(nullptr);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *args = Py_BuildValue("(Oss)", h->obj, layer_name, tag);
  PyObject *r = call_helper("net_get_weight", args);
  if (r == nullptr) return nullptr;
  if (r == Py_None) { /* unknown weight: ndim 0, null ptr, no error */
    Py_DECREF(r);
    if (out_ndim) *out_ndim = 0;
    return nullptr;
  }
  return return_array(h, r, out_shape, out_ndim);
}

int CXNNetSetWeight(void *handle, const cxx_real_t *weight, cxx_ulong size,
                    const char *layer_name, const char *tag) {
  API_PROLOG(-1);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *args = Py_BuildValue(
      "(ONKss)", h->obj, mem_ro(weight, sizeof(cxx_real_t) * size),
      (unsigned long long)size, layer_name, tag);
  PyObject *r = call_helper("net_set_weight", args);
  if (r == nullptr) return -1;
  Py_DECREF(r);
  return 0;
}

/* ---- iterators ---- */

void *CXNIOCreateFromConfig(const char *cfg) {
  API_PROLOG(nullptr);
  PyObject *r = call_helper("io_create", Py_BuildValue("(s)", cfg));
  if (r == nullptr) return nullptr;
  Handle *h = new Handle();
  h->obj = r;
  return h;
}

void CXNIOFree(void *handle) { CXNNetFree(handle); }

int CXNIONext(void *handle) {
  API_PROLOG(-1);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *r = PyObject_CallMethod(h->obj, "next", nullptr);
  if (r == nullptr) { set_error_from_python(); return -1; }
  int v = PyObject_IsTrue(r);
  Py_DECREF(r);
  return v;
}

int CXNIOBeforeFirst(void *handle) {
  API_PROLOG(-1);
  return method0(handle, "before_first");
}

const cxx_real_t *CXNIOGetData(void *handle, cxx_ulong *out_shape,
                               int *out_ndim) {
  API_PROLOG(nullptr);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *args = Py_BuildValue("(O)", h->obj);
  return return_array(h, call_helper("io_get_data", args), out_shape,
                      out_ndim);
}

const cxx_real_t *CXNIOGetLabel(void *handle, cxx_ulong *out_shape,
                                int *out_ndim) {
  API_PROLOG(nullptr);
  Handle *h = static_cast<Handle *>(handle);
  PyObject *args = Py_BuildValue("(O)", h->obj);
  return return_array(h, call_helper("io_get_label", args), out_shape,
                      out_ndim);
}

/* ---- task driver ---- */

int CXNRunTask(int argc, const char **argv) {
  API_PROLOG(-1);
  PyObject *lst = PyList_New(argc);
  if (lst == nullptr) { set_error_from_python(); return -1; }
  for (int i = 0; i < argc; ++i) {
    /* DecodeFSDefault: argv may be arbitrary bytes (paths), not UTF-8 */
    PyObject *s = PyUnicode_DecodeFSDefault(argv[i]);
    if (s == nullptr) {
      set_error_from_python();
      Py_DECREF(lst);
      return -1;
    }
    PyList_SetItem(lst, i, s);  /* steals ref */
  }
  PyObject *args = Py_BuildValue("(O)", lst);
  Py_DECREF(lst);
  PyObject *r = call_helper("run_task", args);
  if (r == nullptr) return -1;
  long rc = PyLong_AsLong(r);
  Py_DECREF(r);
  if (rc == -1 && PyErr_Occurred()) {
    /* run_task returned a non-integer: record and clear the conversion
       error so no stale exception state leaks into the next API call */
    set_error_from_python();
    return -1;
  }
  return static_cast<int>(rc);
}

void CXNShutdown(void) {
  if (g_shutdown || !Py_IsInitialized()) return;
  {
    Gil gil_;
    PyRun_SimpleString(
        "import sys; sys.stdout.flush(); sys.stderr.flush()");
    Py_XDECREF(g_helpers);
  }
  g_helpers = nullptr;  /* would dangle across an interpreter cycle */
  if (g_we_initialized) {
    /* re-acquire the thread state released in ensure_init, then tear down */
    PyGILState_Ensure();
    Py_FinalizeEx();
    g_we_initialized = false;
  }
  /* one-way: every later CXN* call fails cleanly via API_PROLOG */
  g_shutdown = true;
}

}  /* extern "C" */
