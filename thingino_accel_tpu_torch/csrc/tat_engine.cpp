/* C ABI engine shim of the PyTorch/CUDA port: embeds CPython and drives
 * thingino_accel_tpu_torch.runtime.Engine.
 *
 * A copy of the repository's csrc/tat_engine.cpp (the JAX package's shim)
 * over the port's Engine, with csrc/tat_engine.h's ABI and version as
 * they are. The reference's public surface is a C API over its runtimes
 * (include/nna_model.h:45-116); here the runtime is the port's engine,
 * so the shim marshals host buffers <-> numpy <-> device. A model loads
 * on the device that thingino_accel_tpu_torch.api.nna_init bound, or on
 * the card when nothing is bound (api._bound). Works both from a plain C
 * host (initializes the interpreter) and inside an existing Python
 * process (PyGILState handles re-entry), which is how the tests drive it
 * through ctypes. thingino_accel_tpu_torch.native.engine_lib builds it.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "tat_engine.h"

namespace {

char g_err[1024] = {0};
bool g_we_initialized = false;

void set_err(const char *msg) {
  std::snprintf(g_err, sizeof(g_err), "%s", msg);
}

void set_err_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      set_err(PyUnicode_AsUTF8(s));
      Py_DECREF(s);
    }
  } else {
    set_err("unknown python error");
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

}  // namespace

struct tat_tensor {
  std::string name;
  std::string dtype;            // numpy dtype string, e.g. "int8"
  std::vector<int64_t> shape;
  std::vector<uint8_t> data;    // host buffer the C caller reads/writes
};

struct tat_model {
  PyObject *engine = nullptr;   // thingino_accel_tpu_torch.runtime.Engine
  std::vector<tat_tensor> inputs;
  std::vector<tat_tensor> outputs;
};

extern "C" {

int tat_init(void) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    /* release the GIL so Gil{} works from any thread */
    PyEval_SaveThread();
  }
  return TAT_SUCCESS;
}

void tat_deinit(void) {
  /* An embedded CUDA runtime does not tear down cleanly mid-process;
   * leave the interpreter alive (matches the reference's nna_deinit
   * keeping mmaps until exit, src/device.c:304). */
}

static bool fill_tensor_meta(PyObject *engine, const char *kind,
                             std::vector<tat_tensor> *out) {
  /* kind: "inputs" or "outputs" — graph tensor names */
  PyObject *graph = PyObject_GetAttrString(engine, "graph");
  if (!graph) return false;
  PyObject *names = PyObject_GetAttrString(graph, kind);
  PyObject *tensors = PyObject_GetAttrString(graph, "tensors");
  bool ok = names && tensors;
  if (ok) {
    Py_ssize_t n = PySequence_Size(names);
    for (Py_ssize_t i = 0; i < n && ok; i++) {
      PyObject *nm = PySequence_GetItem(names, i);
      PyObject *ti = PyObject_GetItem(tensors, nm);
      PyObject *shape = ti ? PyObject_GetAttrString(ti, "shape") : nullptr;
      PyObject *dt = ti ? PyObject_GetAttrString(ti, "dtype") : nullptr;
      PyObject *dts = dt ? PyObject_Str(dt) : nullptr;
      if (nm && ti && shape && dts) {
        tat_tensor t;
        t.name = PyUnicode_AsUTF8(nm);
        t.dtype = PyUnicode_AsUTF8(dts);
        Py_ssize_t nd = PySequence_Size(shape);
        int64_t bytes = 1;
        for (Py_ssize_t d = 0; d < nd; d++) {
          PyObject *v = PySequence_GetItem(shape, d);
          t.shape.push_back(PyLong_AsLongLong(v));
          bytes *= t.shape.back();
          Py_DECREF(v);
        }
        // dtype strings numpy cannot construct (e.g. "bfloat16") or
        // non-int shape dims must surface as an error, not a NULL
        // deref / negative allocation
        PyObject *np = PyImport_ImportModule("numpy");
        PyObject *dtype_obj = np ? PyObject_CallMethod(
            np, "dtype", "s", t.dtype.c_str()) : nullptr;
        PyObject *isz = dtype_obj
            ? PyObject_GetAttrString(dtype_obj, "itemsize") : nullptr;
        int64_t item = isz ? PyLong_AsLongLong(isz) : -1;
        Py_XDECREF(isz);
        Py_XDECREF(dtype_obj);
        Py_XDECREF(np);
        if (item <= 0 || bytes < 0 || PyErr_Occurred()) {
          PyErr_Clear();
          ok = false;
        } else {
          bytes *= item;
          t.data.assign(static_cast<size_t>(bytes), 0);
          out->push_back(std::move(t));
        }
      } else {
        ok = false;
      }
      Py_XDECREF(dts);
      Py_XDECREF(dt);
      Py_XDECREF(shape);
      Py_XDECREF(ti);
      Py_XDECREF(nm);
    }
  }
  Py_XDECREF(tensors);
  Py_XDECREF(names);
  Py_DECREF(graph);
  return ok;
}

tat_model_t *tat_model_load(const char *path) {
  if (!path) {
    set_err("null path");
    return nullptr;
  }
  if (tat_init() != TAT_SUCCESS) return nullptr;
  Gil gil;
  PyObject *mod = PyImport_ImportModule("thingino_accel_tpu_torch.runtime");
  PyObject *api = mod ? PyImport_ImportModule("thingino_accel_tpu_torch.api")
                      : nullptr;
  if (!api) {
    set_err_from_python();
    Py_XDECREF(mod);
    return nullptr;
  }
  /* the device nna_init bound, else the card (raises without one) */
  PyObject *device = PyObject_CallMethod(api, "_bound", nullptr);
  PyObject *cls = device ? PyObject_GetAttrString(mod, "Engine") : nullptr;
  PyObject *from_mars =
      cls ? PyObject_GetAttrString(cls, "from_mars") : nullptr;
  PyObject *engine = nullptr;
  if (from_mars) {
    PyObject *args = Py_BuildValue("(s)", path);
    PyObject *kwargs = Py_BuildValue("{s:O}", "device", device);
    engine = (args && kwargs) ? PyObject_Call(from_mars, args, kwargs)
                              : nullptr;
    Py_XDECREF(kwargs);
    Py_XDECREF(args);
  }
  Py_XDECREF(from_mars);
  Py_XDECREF(cls);
  Py_XDECREF(device);
  Py_DECREF(api);
  Py_DECREF(mod);
  if (!engine) {
    set_err_from_python();
    return nullptr;
  }
  auto *m = new tat_model;
  m->engine = engine;
  if (!fill_tensor_meta(engine, "inputs", &m->inputs) ||
      !fill_tensor_meta(engine, "outputs", &m->outputs)) {
    set_err_from_python();
    Py_DECREF(engine);
    delete m;
    return nullptr;
  }
  return m;
}

int tat_model_run(tat_model_t *m) {
  if (!m || !m->engine) {
    set_err("null model");
    return TAT_ERROR_INVALID_PARAM;
  }
  Gil gil;
  PyObject *np = PyImport_ImportModule("numpy");
  if (!np) {
    set_err_from_python();
    return TAT_ERROR_RUNTIME;
  }
  PyObject *kwargs = PyDict_New();
  bool ok = true;
  for (auto &t : m->inputs) {
    /* bytearray -> np.frombuffer(dtype).reshape(shape): a writable
     * array, which torch takes without a copy's warning */
    PyObject *buf = PyByteArray_FromStringAndSize(
        reinterpret_cast<const char *>(t.data.data()),
        static_cast<Py_ssize_t>(t.data.size()));
    PyObject *arr =
        PyObject_CallMethod(np, "frombuffer", "Os", buf, t.dtype.c_str());
    PyObject *shape = PyTuple_New(static_cast<Py_ssize_t>(t.shape.size()));
    for (size_t d = 0; d < t.shape.size(); d++)
      PyTuple_SET_ITEM(shape, d, PyLong_FromLongLong(t.shape[d]));
    PyObject *rarr =
        arr ? PyObject_CallMethod(arr, "reshape", "O", shape) : nullptr;
    if (rarr) {
      PyDict_SetItemString(kwargs, t.name.c_str(), rarr);
      Py_DECREF(rarr);
    } else {
      ok = false;
    }
    Py_XDECREF(arr);
    Py_DECREF(shape);
    Py_DECREF(buf);
  }
  PyObject *result = nullptr;
  if (ok) {
    PyObject *run = PyObject_GetAttrString(m->engine, "run_np");
    PyObject *empty = PyTuple_New(0);
    result = run ? PyObject_Call(run, empty, kwargs) : nullptr;
    Py_DECREF(empty);
    Py_XDECREF(run);
  }
  Py_DECREF(kwargs);
  if (!result) {
    set_err_from_python();
    Py_DECREF(np);
    return TAT_ERROR_RUNTIME;
  }
  for (auto &t : m->outputs) {
    PyObject *arr = PyMapping_GetItemString(result, t.name.c_str());
    PyObject *carr = arr ? PyObject_CallMethod(np, "ascontiguousarray",
                                               "O", arr) : nullptr;
    PyObject *bytes =
        carr ? PyObject_CallMethod(carr, "tobytes", nullptr) : nullptr;
    if (bytes) {
      char *p = nullptr;
      Py_ssize_t n = 0;
      PyBytes_AsStringAndSize(bytes, &p, &n);
      t.data.resize(static_cast<size_t>(n));
      std::memcpy(t.data.data(), p, static_cast<size_t>(n));
      Py_DECREF(bytes);
    } else {
      ok = false;
    }
    Py_XDECREF(carr);
    Py_XDECREF(arr);
  }
  Py_DECREF(result);
  Py_DECREF(np);
  if (!ok) {
    set_err_from_python();
    return TAT_ERROR_RUNTIME;
  }
  return TAT_SUCCESS;
}

void tat_model_unload(tat_model_t *m) {
  if (!m) return;
  {
    Gil gil;
    Py_XDECREF(m->engine);
  }
  delete m;
}

int tat_model_num_inputs(tat_model_t *m) {
  return m ? static_cast<int>(m->inputs.size()) : 0;
}
int tat_model_num_outputs(tat_model_t *m) {
  return m ? static_cast<int>(m->outputs.size()) : 0;
}
tat_tensor_t *tat_model_get_input(tat_model_t *m, uint32_t i) {
  return (m && i < m->inputs.size()) ? &m->inputs[i] : nullptr;
}
tat_tensor_t *tat_model_get_output(tat_model_t *m, uint32_t i) {
  return (m && i < m->outputs.size()) ? &m->outputs[i] : nullptr;
}
const char *tat_tensor_name(const tat_tensor_t *t) {
  return t ? t->name.c_str() : nullptr;
}
int tat_tensor_ndim(const tat_tensor_t *t) {
  return t ? static_cast<int>(t->shape.size()) : 0;
}
const int64_t *tat_tensor_shape(const tat_tensor_t *t) {
  return t ? t->shape.data() : nullptr;
}
int64_t tat_tensor_bytes(const tat_tensor_t *t) {
  return t ? static_cast<int64_t>(t->data.size()) : 0;
}
const char *tat_tensor_dtype(const tat_tensor_t *t) {
  return t ? t->dtype.c_str() : nullptr;
}
void *tat_tensor_data(tat_tensor_t *t) {
  return t ? t->data.data() : nullptr;
}
const char *tat_last_error(void) { return g_err; }
int tat_engine_abi_version(void) { return 1; }

}  // extern "C"
