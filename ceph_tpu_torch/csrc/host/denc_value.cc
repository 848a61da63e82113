// CPython extension: the denc generic tagged-value codec, in C.
// Copied from ceph_tpu's native/denc_value.cc; only the module's name
// differs (the port builds it at first use, common/denc_native.py).
//
// Same byte format as ceph_tpu_torch/common/denc.py Encoder._value_py /
// Decoder._value_py (the pure-Python reference implementation, kept for
// the exact-type mismatches this codec refuses).  The wire meta of EVERY
// message runs through this codec (msg/message.py), so it is the hottest
// serialization path of an in-process cluster; the reference's denc.h is
// likewise C++ for this reason.
//
// Tags: 0 None | 1 True | 2 False | 3 i64 | 4 f64 | 5 str | 6 bytes
//       7 list | 8 dict(str keys) | 9 bignum (decimal text)
// All integers little-endian; str/bytes are u32 length + payload.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buf {
  std::vector<uint8_t> b;
  void u8(uint8_t v) { b.push_back(v); }
  void u32(uint32_t v) {
    uint8_t t[4];
    memcpy(t, &v, 4);  // little-endian hosts only (x86/arm64)
    b.insert(b.end(), t, t + 4);
  }
  void i64(int64_t v) {
    uint8_t t[8];
    memcpy(t, &v, 8);
    b.insert(b.end(), t, t + 8);
  }
  void f64(double v) {
    uint8_t t[8];
    memcpy(t, &v, 8);
    b.insert(b.end(), t, t + 8);
  }
  void raw(const char* p, Py_ssize_t n) {
    b.insert(b.end(), p, p + n);
  }
};

int encode_value(Buf& out, PyObject* v, int depth) {
  if (depth > 200) {
    PyErr_SetString(PyExc_ValueError, "value nesting too deep");
    return -1;
  }
  if (v == Py_None) {
    out.u8(0);
    return 0;
  }
  if (v == Py_True) {
    out.u8(1);
    return 0;
  }
  if (v == Py_False) {
    out.u8(2);
    return 0;
  }
  if (PyLong_CheckExact(v)) {
    int overflow = 0;
    long long n = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (!overflow) {
      out.u8(3);
      out.i64((int64_t)n);
      return 0;
    }
    // bignum: decimal text (tag 9)
    PyObject* s = PyObject_Str(v);
    if (!s) return -1;
    Py_ssize_t sn;
    const char* sp = PyUnicode_AsUTF8AndSize(s, &sn);
    if (!sp) {
      Py_DECREF(s);
      return -1;
    }
    out.u8(9);
    out.u32((uint32_t)sn);
    out.raw(sp, sn);
    Py_DECREF(s);
    return 0;
  }
  if (PyFloat_CheckExact(v)) {
    out.u8(4);
    out.f64(PyFloat_AS_DOUBLE(v));
    return 0;
  }
  if (PyUnicode_CheckExact(v)) {
    Py_ssize_t sn;
    const char* sp = PyUnicode_AsUTF8AndSize(v, &sn);
    if (!sp) return -1;
    out.u8(5);
    out.u32((uint32_t)sn);
    out.raw(sp, sn);
    return 0;
  }
  if (PyBytes_CheckExact(v)) {
    out.u8(6);
    out.u32((uint32_t)PyBytes_GET_SIZE(v));
    out.raw(PyBytes_AS_STRING(v), PyBytes_GET_SIZE(v));
    return 0;
  }
  if (PyByteArray_CheckExact(v)) {
    out.u8(6);
    out.u32((uint32_t)PyByteArray_GET_SIZE(v));
    out.raw(PyByteArray_AS_STRING(v), PyByteArray_GET_SIZE(v));
    return 0;
  }
  if (PyList_CheckExact(v) || PyTuple_CheckExact(v)) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(v);
    out.u8(7);
    out.u32((uint32_t)n);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (encode_value(out, PySequence_Fast_GET_ITEM(v, i),
                       depth + 1) < 0)
        return -1;
    }
    return 0;
  }
  if (PyDict_CheckExact(v)) {
    out.u8(8);
    out.u32((uint32_t)PyDict_GET_SIZE(v));
    PyObject *key, *val;
    Py_ssize_t pos = 0;
    while (PyDict_Next(v, &pos, &key, &val)) {
      if (PyUnicode_CheckExact(key)) {
        Py_ssize_t sn;
        const char* sp = PyUnicode_AsUTF8AndSize(key, &sn);
        if (!sp) return -1;
        out.u32((uint32_t)sn);
        out.raw(sp, sn);
      } else {
        // json.dumps key coercion: str(key)
        PyObject* s = PyObject_Str(key);
        if (!s) return -1;
        Py_ssize_t sn;
        const char* sp = PyUnicode_AsUTF8AndSize(s, &sn);
        if (!sp) {
          Py_DECREF(s);
          return -1;
        }
        out.u32((uint32_t)sn);
        out.raw(sp, sn);
        Py_DECREF(s);
      }
      if (encode_value(out, val, depth + 1) < 0) return -1;
    }
    return 0;
  }
  // subclasses of int/str/etc. and foreign types drop to the Python
  // fallback (which may raise DencError -> json escape hatch)
  PyErr_Format(PyExc_TypeError, "unencodable value type %.100s",
               Py_TYPE(v)->tp_name);
  return -1;
}

struct Cur {
  const uint8_t* p;
  Py_ssize_t n;
  Py_ssize_t pos;
  bool need(Py_ssize_t k) {
    if (pos + k > n) {
      PyErr_SetString(PyExc_ValueError, "denc value: decode past end");
      return false;
    }
    return true;
  }
  bool ru8(uint8_t* v) {
    if (!need(1)) return false;
    *v = p[pos++];
    return true;
  }
  bool ru32(uint32_t* v) {
    if (!need(4)) return false;
    memcpy(v, p + pos, 4);
    pos += 4;
    return true;
  }
  bool ri64(int64_t* v) {
    if (!need(8)) return false;
    memcpy(v, p + pos, 8);
    pos += 8;
    return true;
  }
  bool rf64(double* v) {
    if (!need(8)) return false;
    memcpy(v, p + pos, 8);
    pos += 8;
    return true;
  }
};

PyObject* decode_value(Cur& c, int depth) {
  if (depth > 200) {
    PyErr_SetString(PyExc_ValueError, "value nesting too deep");
    return nullptr;
  }
  uint8_t tag;
  if (!c.ru8(&tag)) return nullptr;
  switch (tag) {
    case 0:
      Py_RETURN_NONE;
    case 1:
      Py_RETURN_TRUE;
    case 2:
      Py_RETURN_FALSE;
    case 3: {
      int64_t v;
      if (!c.ri64(&v)) return nullptr;
      return PyLong_FromLongLong(v);
    }
    case 4: {
      double v;
      if (!c.rf64(&v)) return nullptr;
      return PyFloat_FromDouble(v);
    }
    case 5: {
      uint32_t ln;
      if (!c.ru32(&ln) || !c.need(ln)) return nullptr;
      PyObject* s = PyUnicode_DecodeUTF8(
          (const char*)c.p + c.pos, ln, nullptr);
      c.pos += ln;
      return s;
    }
    case 6: {
      uint32_t ln;
      if (!c.ru32(&ln) || !c.need(ln)) return nullptr;
      PyObject* b =
          PyBytes_FromStringAndSize((const char*)c.p + c.pos, ln);
      c.pos += ln;
      return b;
    }
    case 7: {
      uint32_t n;
      if (!c.ru32(&n)) return nullptr;
      if ((Py_ssize_t)n > c.n - c.pos) {  // min 1 byte per element
        PyErr_SetString(PyExc_ValueError, "denc value: bad list len");
        return nullptr;
      }
      PyObject* lst = PyList_New(n);
      if (!lst) return nullptr;
      for (uint32_t i = 0; i < n; i++) {
        PyObject* it = decode_value(c, depth + 1);
        if (!it) {
          Py_DECREF(lst);
          return nullptr;
        }
        PyList_SET_ITEM(lst, i, it);
      }
      return lst;
    }
    case 8: {
      uint32_t n;
      if (!c.ru32(&n)) return nullptr;
      if ((Py_ssize_t)n > (c.n - c.pos) / 5) {  // min 5 bytes/entry
        PyErr_SetString(PyExc_ValueError, "denc value: bad dict len");
        return nullptr;
      }
      PyObject* d = PyDict_New();
      if (!d) return nullptr;
      for (uint32_t i = 0; i < n; i++) {
        uint32_t kl;
        if (!c.ru32(&kl) || !c.need(kl)) {
          Py_DECREF(d);
          return nullptr;
        }
        PyObject* k = PyUnicode_DecodeUTF8(
            (const char*)c.p + c.pos, kl, nullptr);
        c.pos += kl;
        if (!k) {
          Py_DECREF(d);
          return nullptr;
        }
        PyObject* v = decode_value(c, depth + 1);
        if (!v) {
          Py_DECREF(k);
          Py_DECREF(d);
          return nullptr;
        }
        int rc = PyDict_SetItem(d, k, v);
        Py_DECREF(k);
        Py_DECREF(v);
        if (rc < 0) {
          Py_DECREF(d);
          return nullptr;
        }
      }
      return d;
    }
    case 9: {
      uint32_t ln;
      if (!c.ru32(&ln) || !c.need(ln)) return nullptr;
      PyObject* s = PyUnicode_DecodeUTF8(
          (const char*)c.p + c.pos, ln, nullptr);
      c.pos += ln;
      if (!s) return nullptr;
      PyObject* v = PyLong_FromUnicodeObject(s, 10);
      Py_DECREF(s);
      return v;
    }
    default:
      PyErr_Format(PyExc_ValueError, "bad value tag %d", tag);
      return nullptr;
  }
}

PyObject* py_encode_value(PyObject*, PyObject* v) {
  Buf out;
  out.b.reserve(256);
  if (encode_value(out, v, 0) < 0) return nullptr;
  return PyBytes_FromStringAndSize((const char*)out.b.data(),
                                   out.b.size());
}

PyObject* py_decode_value(PyObject*, PyObject* args) {
  Py_buffer view;
  Py_ssize_t offset = 0;
  if (!PyArg_ParseTuple(args, "y*|n", &view, &offset)) return nullptr;
  Cur c{(const uint8_t*)view.buf, view.len, offset};
  PyObject* v = decode_value(c, 0);
  Py_ssize_t end = c.pos;
  PyBuffer_Release(&view);
  if (!v) return nullptr;
  PyObject* out = Py_BuildValue("(Nn)", v, end);
  return out;
}

PyMethodDef methods[] = {
    {"encode_value", py_encode_value, METH_O,
     "encode_value(obj) -> bytes (denc tagged value)"},
    {"decode_value", py_decode_value, METH_VARARGS,
     "decode_value(buf, offset=0) -> (obj, end_offset)"},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "ceph_tpu_torch_denc",
                          "denc tagged-value codec (C)", -1, methods,
                          nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_ceph_tpu_torch_denc(void) {
  return PyModule_Create(&mod);
}
