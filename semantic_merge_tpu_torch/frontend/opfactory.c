/* semmerge_opfactory — C op-object factory for the columnar op logs.
 *
 * The fused merge path keeps op logs as int32/digest columns
 * (semantic_merge_tpu_torch/ops/oplog_view.py); consumers that need real Op
 * objects (the applier's handler dispatch, parity tests, the bench's
 * honest composed-stream consumption) previously materialized them in
 * Python at ~2 us/op — the largest host phase left after the native
 * JSON serializer. This extension builds the same objects with the
 * CPython C API: Op/Target instances via tp_new-free __new__ +
 * slot SetAttr, params/guards/effects as small dicts.
 *
 * v2 (host-tail pipelining): field strings come from per-snapshot
 * Python STRING LISTS (one list per node column: symbolId, addressId,
 * name, file — built once per snapshot and cached by the engine)
 * instead of being UTF-8-decoded out of a byte blob per op. A 46k-op
 * composed stream used to allocate ~230k fresh field strings per
 * materialize; now every field is a borrowed PyList_GET_ITEM + the
 * dict insert's incref. Only the op id (uuid) and the summary string
 * are created per op.
 *
 * Two entry points (STREAM = kind, a_slot, b_slot, words,
 * b_sym, b_addr, b_name, b_file, s_sym, s_addr, s_name, s_file):
 *   stream_ops(STREAM, prov, op_cls, target_cls) -> list[Op]
 *   composed_ops(STREAM_left, STREAM_right, sides, idxs,
 *                addr_ov, file_ov, name_ov,
 *                prov_left, prov_right, op_cls, target_cls) -> list[Op]
 * composed_ops applies the chain-override rules of
 * oplog_view._materialize_decoded row-by-row, building each final
 * composed op directly — the intermediate per-side stream objects are
 * never created. ``sides``/``idxs`` may be any row range (the tail
 * pipeline materializes shard slices independently and concatenates
 * in shard order). Byte-for-byte to_dict parity with the Python
 * materializers is tested in tests/test_torch_native_ops.py. Built at
 * first use by semantic_merge_tpu_torch/frontend/native.py::load_opfactory.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

/* Interned field/key names, created at module init. */
static PyObject *S_id, *S_schemaVersion, *S_type, *S_target, *S_params,
    *S_guards, *S_effects, *S_provenance, *S_symbolId, *S_addressId,
    *S_oldName, *S_newName, *S_file, *S_oldAddress, *S_newAddress,
    *S_oldFile, *S_newFile, *S_exists, *S_addressMatch, *S_summary,
    *S_renameContext;
static PyObject *T_renameSymbol, *T_moveDecl, *T_addDecl, *T_deleteDecl;
static PyObject *SUM_add, *SUM_del, *ARROW, *SUM_ren_prefix, *SUM_mov_prefix;
static PyObject *ONE;

typedef struct {
  const int32_t *kind, *a_slot, *b_slot;
  const int32_t *words; /* n*4 */
  /* Borrowed per-node field lists: [0..3] base sym/addr/name/file,
   * [4..7] side sym/addr/name/file. */
  PyObject *bf[4], *sf[4];
  Py_ssize_t nb, ns; /* node counts (list lengths) */
} Stream;

/* Slot descriptors fetched once per entry call: setting through
 * tp_descr_set skips the generic attribute machinery, and tp_alloc
 * skips the __new__ Python call — together ~3x on object build. */
typedef struct {
  PyTypeObject *op_t, *tgt_t;
  PyObject *op_d[8];  /* id, schemaVersion, type, target, params,
                         guards, effects, provenance */
  PyObject *tgt_d[2]; /* symbolId, addressId */
  int ok;
} Factory;

static int dset(PyObject *descr, PyObject *obj, PyObject *val) {
  /* factory_init guarantees tp_descr_set exists for every descriptor */
  return Py_TYPE(descr)->tp_descr_set(descr, obj, val);
}

static int factory_init(Factory *f, PyObject *op_cls, PyObject *target_cls) {
  memset(f, 0, sizeof(*f));
  if (!PyType_Check(op_cls) || !PyType_Check(target_cls)) {
    PyErr_SetString(PyExc_TypeError, "op_cls/target_cls must be types");
    return -1;
  }
  f->op_t = (PyTypeObject *)op_cls;
  f->tgt_t = (PyTypeObject *)target_cls;
  PyObject *names[8] = {S_id, S_schemaVersion, S_type, S_target, S_params,
                        S_guards, S_effects, S_provenance};
  for (int i = 0; i < 8; i++) {
    f->op_d[i] = PyObject_GetAttr(op_cls, names[i]);
    if (!f->op_d[i] || !Py_TYPE(f->op_d[i])->tp_descr_set) {
      PyErr_SetString(PyExc_TypeError, "op_cls lacks slot descriptors");
      return -1;
    }
  }
  PyObject *tnames[2] = {S_symbolId, S_addressId};
  for (int i = 0; i < 2; i++) {
    f->tgt_d[i] = PyObject_GetAttr(target_cls, tnames[i]);
    if (!f->tgt_d[i] || !Py_TYPE(f->tgt_d[i])->tp_descr_set) {
      PyErr_SetString(PyExc_TypeError, "target_cls lacks slot descriptors");
      return -1;
    }
  }
  f->ok = 1;
  return 0;
}

static void factory_clear(Factory *f) {
  for (int i = 0; i < 8; i++) Py_XDECREF(f->op_d[i]);
  for (int i = 0; i < 2; i++) Py_XDECREF(f->tgt_d[i]);
}

/* Borrowed field f (0 sym, 1 addr, 2 name, 3 file) of a node. */
static PyObject *fld(PyObject *const lists[4], Py_ssize_t n, Py_ssize_t node,
                     int f) {
  if (node < 0 || node >= n) {
    PyErr_SetString(PyExc_ValueError, "node index out of range");
    return NULL;
  }
  return PyList_GET_ITEM(lists[f], node);
}

static const char HEXD[] = "0123456789abcdef";

static PyObject *uuid_str(const int32_t *w4) {
  char buf[36];
  char hex[32];
  for (int k = 0; k < 4; k++) {
    uint32_t v = (uint32_t)w4[k];
    for (int j = 7; j >= 0; j--) {
      hex[k * 8 + j] = HEXD[v & 0xF];
      v >>= 4;
    }
  }
  int p = 0;
  for (int i = 0; i < 32; i++) {
    if (i == 8 || i == 12 || i == 16 || i == 20) buf[p++] = '-';
    buf[p++] = hex[i];
  }
  return PyUnicode_FromStringAndSize(buf, 36);
}

/* sym/addr borrowed; result owned by caller. */
static PyObject *make_target(const Factory *f, PyObject *sym,
                             PyObject *addr) {
  PyObject *t = f->tgt_t->tp_alloc(f->tgt_t, 0);
  if (!t) return NULL;
  if (dset(f->tgt_d[0], t, sym) < 0 || dset(f->tgt_d[1], t, addr) < 0) {
    Py_DECREF(t);
    return NULL;
  }
  return t;
}

/* Assemble one Op. op_id/type/prov borrowed;
 * target/params/guards/effects are owned refs STOLEN from the caller. */
static PyObject *make_op(const Factory *f, PyObject *op_id, PyObject *type,
                         PyObject *target /* stolen */,
                         PyObject *params /* stolen */,
                         PyObject *guards /* stolen */,
                         PyObject *effects /* stolen */, PyObject *prov) {
  PyObject *op = f->op_t->tp_alloc(f->op_t, 0);
  if (!op) goto fail;
  if (dset(f->op_d[0], op, op_id) < 0) goto fail_op;
  if (dset(f->op_d[1], op, ONE) < 0) goto fail_op;
  if (dset(f->op_d[2], op, type) < 0) goto fail_op;
  if (dset(f->op_d[3], op, target) < 0) goto fail_op;
  if (dset(f->op_d[4], op, params) < 0) goto fail_op;
  if (dset(f->op_d[5], op, guards) < 0) goto fail_op;
  if (dset(f->op_d[6], op, effects) < 0) goto fail_op;
  if (dset(f->op_d[7], op, prov) < 0) goto fail_op;
  Py_DECREF(target);
  Py_DECREF(params);
  Py_DECREF(guards);
  Py_DECREF(effects);
  return op;
fail_op:
  Py_DECREF(op);
fail:
  Py_XDECREF(target);
  Py_XDECREF(params);
  Py_XDECREF(guards);
  Py_XDECREF(effects);
  return NULL;
}

static PyObject *guards_for(PyObject *addr /* borrowed */) {
  PyObject *g = PyDict_New();
  if (!g) return NULL;
  if (PyDict_SetItem(g, S_exists, Py_True) < 0 ||
      PyDict_SetItem(g, S_addressMatch, addr) < 0) {
    Py_DECREF(g);
    return NULL;
  }
  return g;
}

static PyObject *summary3(PyObject *prefix, PyObject *a, PyObject *b) {
  /* prefix + a + ARROW + b */
  PyObject *s1 = PyUnicode_Concat(prefix, a);
  if (!s1) return NULL;
  PyObject *s2 = PyUnicode_Concat(s1, ARROW);
  Py_DECREF(s1);
  if (!s2) return NULL;
  PyObject *s3 = PyUnicode_Concat(s2, b);
  Py_DECREF(s2);
  return s3;
}

static PyObject *effects_summary(PyObject *summary /* stolen */) {
  if (!summary) return NULL;
  PyObject *e = PyDict_New();
  if (!e) {
    Py_DECREF(summary);
    return NULL;
  }
  if (PyDict_SetItem(e, S_summary, summary) < 0) {
    Py_DECREF(summary);
    Py_DECREF(e);
    return NULL;
  }
  Py_DECREF(summary);
  return e;
}

/* Build op i of a stream, applying composed-row overrides when
 * addr_ov/file_ov/name_ov are non-NULL (borrowed, may be Py_None).
 * Override semantics mirror oplog_view._materialize_decoded exactly,
 * except ops are always built fresh (value-identical). All field
 * strings are borrowed from the stream's node field lists. */
static PyObject *build_op(const Stream *s, Py_ssize_t i, PyObject *prov,
                          const Factory *f, PyObject *addr_ov,
                          PyObject *file_ov, PyObject *name_ov) {
  int k = s->kind[i];
  PyObject *op_id = uuid_str(s->words + 4 * i);
  if (!op_id) return NULL;
  PyObject *result = NULL;
  int has_addr = addr_ov && addr_ov != Py_None;
  int has_file = file_ov && file_ov != Py_None;
  int has_name = name_ov && name_ov != Py_None;

  if (k == 0 || k == 1) { /* renameSymbol / moveDecl */
    Py_ssize_t an = s->a_slot[i], bn = s->b_slot[i];
    PyObject *a_sym = fld(s->bf, s->nb, an, 0);
    PyObject *a_addr = fld(s->bf, s->nb, an, 1);
    if (!a_sym || !a_addr) goto done;
    PyObject *target = make_target(f, a_sym, has_addr ? addr_ov : a_addr);
    PyObject *guards = guards_for(a_addr);
    if (!target || !guards) {
      Py_XDECREF(target);
      Py_XDECREF(guards);
      goto done;
    }
    if (k == 0) { /* renameSymbol */
      PyObject *a_name = fld(s->bf, s->nb, an, 2);
      PyObject *b_name = fld(s->sf, s->ns, bn, 2);
      PyObject *b_file = fld(s->sf, s->ns, bn, 3);
      if (!a_name || !b_name || !b_file) {
        Py_DECREF(target);
        Py_DECREF(guards);
        goto done;
      }
      PyObject *params = PyDict_New();
      int ok = params && PyDict_SetItem(params, S_oldName, a_name) == 0 &&
               PyDict_SetItem(params, S_newName, b_name) == 0 &&
               PyDict_SetItem(params, S_file,
                              has_file ? file_ov : b_file) == 0;
      if (ok && has_file) /* rename + chained file: newFile then file */
        ok = PyDict_SetItem(params, S_newFile, file_ov) == 0;
      /* NOTE: _materialize_decoded sets newFile THEN overwrites file;
       * insertion order is oldName,newName,file,newFile — file was
       * already inserted above, so order matches. renameContext never
       * applies to renameSymbol. */
      PyObject *effects =
          ok ? effects_summary(summary3(SUM_ren_prefix, a_name, b_name))
             : NULL;
      if (!ok || !effects) {
        Py_XDECREF(params);
        Py_XDECREF(effects);
        Py_DECREF(target);
        Py_DECREF(guards);
        goto done;
      }
      result = make_op(f, op_id, T_renameSymbol, target, params, guards,
                       effects, prov);
    } else { /* moveDecl */
      PyObject *b_addr = fld(s->sf, s->ns, bn, 1);
      PyObject *a_file = fld(s->bf, s->nb, an, 3);
      PyObject *b_file = fld(s->sf, s->ns, bn, 3);
      if (!b_addr || !a_file || !b_file) {
        Py_DECREF(target);
        Py_DECREF(guards);
        goto done;
      }
      PyObject *params = PyDict_New();
      int ok = params && PyDict_SetItem(params, S_oldAddress, a_addr) == 0 &&
               PyDict_SetItem(params, S_newAddress,
                              has_addr ? addr_ov : b_addr) == 0 &&
               PyDict_SetItem(params, S_oldFile, a_file) == 0 &&
               PyDict_SetItem(params, S_newFile,
                              has_file ? file_ov : b_file) == 0;
      if (ok && has_name)
        ok = PyDict_SetItem(params, S_renameContext, name_ov) == 0;
      PyObject *effects =
          ok ? effects_summary(summary3(SUM_mov_prefix, a_addr, b_addr))
             : NULL;
      if (!ok || !effects) {
        Py_XDECREF(params);
        Py_XDECREF(effects);
        Py_DECREF(target);
        Py_DECREF(guards);
        goto done;
      }
      result = make_op(f, op_id, T_moveDecl, target, params, guards,
                       effects, prov);
    }
  } else { /* addDecl (2) / deleteDecl (3) */
    PyObject *const *lists = (k == 2) ? s->sf : s->bf;
    Py_ssize_t nn = (k == 2) ? s->ns : s->nb;
    Py_ssize_t node = (k == 2) ? s->b_slot[i] : s->a_slot[i];
    PyObject *sym = fld(lists, nn, node, 0);
    PyObject *addr = fld(lists, nn, node, 1);
    PyObject *fil = fld(lists, nn, node, 3);
    if (!sym || !addr || !fil) goto done;
    PyObject *target = make_target(f, sym, has_addr ? addr_ov : addr);
    PyObject *params = PyDict_New();
    int ok = target && params && PyDict_SetItem(params, S_file, fil) == 0;
    if (ok && has_name)
      ok = PyDict_SetItem(params, S_renameContext, name_ov) == 0;
    PyObject *guards = ok ? PyDict_New() : NULL;
    PyObject *effects = NULL;
    if (ok && guards) {
      PyObject *sum = (k == 2) ? SUM_add : SUM_del;
      Py_INCREF(sum);
      effects = effects_summary(sum);
    }
    if (!ok || !guards || !effects) {
      Py_XDECREF(target);
      Py_XDECREF(params);
      Py_XDECREF(guards);
      Py_XDECREF(effects);
      goto done;
    }
    result = make_op(f, op_id, (k == 2) ? T_addDecl : T_deleteDecl,
                     target, params, guards, effects, prov);
  }
done:
  Py_DECREF(op_id);
  return result;
}

/* ---- argument plumbing ---- */

typedef struct {
  Py_buffer kind, a_slot, b_slot, words;
  Stream s;
  Py_ssize_t n;
  int held;
} StreamArgs;

/* One stream is 12 consecutive args: 4 int32 column buffers followed
 * by 8 field lists (base sym/addr/name/file, side sym/addr/name/file). */
static int get_stream(PyObject *args, Py_ssize_t off, StreamArgs *sa) {
  PyObject *kind = PyTuple_GET_ITEM(args, off);
  PyObject *a_slot = PyTuple_GET_ITEM(args, off + 1);
  PyObject *b_slot = PyTuple_GET_ITEM(args, off + 2);
  PyObject *words = PyTuple_GET_ITEM(args, off + 3);
  memset(sa, 0, sizeof(*sa));
  for (int i = 0; i < 8; i++) {
    PyObject *lst = PyTuple_GET_ITEM(args, off + 4 + i);
    if (!PyList_Check(lst)) {
      PyErr_SetString(PyExc_TypeError, "node field columns must be lists");
      return -1;
    }
    if (i < 4)
      sa->s.bf[i] = lst;
    else
      sa->s.sf[i - 4] = lst;
  }
  sa->s.nb = PyList_GET_SIZE(sa->s.bf[0]);
  sa->s.ns = PyList_GET_SIZE(sa->s.sf[0]);
  for (int i = 1; i < 4; i++) {
    if (PyList_GET_SIZE(sa->s.bf[i]) != sa->s.nb ||
        PyList_GET_SIZE(sa->s.sf[i]) != sa->s.ns) {
      PyErr_SetString(PyExc_ValueError, "node field list length mismatch");
      return -1;
    }
  }
  if (PyObject_GetBuffer(kind, &sa->kind, PyBUF_C_CONTIGUOUS) < 0) return -1;
  if (PyObject_GetBuffer(a_slot, &sa->a_slot, PyBUF_C_CONTIGUOUS) < 0) goto f1;
  if (PyObject_GetBuffer(b_slot, &sa->b_slot, PyBUF_C_CONTIGUOUS) < 0) goto f2;
  if (PyObject_GetBuffer(words, &sa->words, PyBUF_C_CONTIGUOUS) < 0) goto f3;
  sa->n = sa->kind.len / 4;
  if (sa->a_slot.len != sa->kind.len || sa->b_slot.len != sa->kind.len ||
      sa->words.len != sa->kind.len * 4) {
    PyErr_SetString(PyExc_ValueError, "column length mismatch");
    goto f4;
  }
  sa->s.kind = (const int32_t *)sa->kind.buf;
  sa->s.a_slot = (const int32_t *)sa->a_slot.buf;
  sa->s.b_slot = (const int32_t *)sa->b_slot.buf;
  sa->s.words = (const int32_t *)sa->words.buf;
  sa->held = 1;
  return 0;
f4:
  PyBuffer_Release(&sa->words);
f3:
  PyBuffer_Release(&sa->b_slot);
f2:
  PyBuffer_Release(&sa->a_slot);
f1:
  PyBuffer_Release(&sa->kind);
  return -1;
}

static void release_stream(StreamArgs *sa) {
  if (!sa->held) return;
  PyBuffer_Release(&sa->kind);
  PyBuffer_Release(&sa->a_slot);
  PyBuffer_Release(&sa->b_slot);
  PyBuffer_Release(&sa->words);
  sa->held = 0;
}

static PyObject *py_stream_ops(PyObject *self, PyObject *args) {
  (void)self;
  if (PyTuple_GET_SIZE(args) != 15) {
    PyErr_SetString(PyExc_TypeError, "stream_ops expects 15 args");
    return NULL;
  }
  StreamArgs sa;
  if (get_stream(args, 0, &sa) < 0) return NULL;
  PyObject *prov = PyTuple_GET_ITEM(args, 12);
  Factory fac;
  if (factory_init(&fac, PyTuple_GET_ITEM(args, 13),
                   PyTuple_GET_ITEM(args, 14)) < 0) {
    factory_clear(&fac);
    release_stream(&sa);
    return NULL;
  }
  PyObject *out = PyList_New(sa.n);
  if (!out) {
    factory_clear(&fac);
    release_stream(&sa);
    return NULL;
  }
  for (Py_ssize_t i = 0; i < sa.n; i++) {
    PyObject *op = build_op(&sa.s, i, prov, &fac, NULL, NULL, NULL);
    if (!op) {
      Py_DECREF(out);
      factory_clear(&fac);
      release_stream(&sa);
      return NULL;
    }
    PyList_SET_ITEM(out, i, op);
  }
  factory_clear(&fac);
  release_stream(&sa);
  return out;
}

static PyObject *py_composed_ops(PyObject *self, PyObject *args) {
  (void)self;
  if (PyTuple_GET_SIZE(args) != 33) {
    PyErr_SetString(PyExc_TypeError, "composed_ops expects 33 args");
    return NULL;
  }
  StreamArgs left, right;
  if (get_stream(args, 0, &left) < 0) return NULL;
  if (get_stream(args, 12, &right) < 0) {
    release_stream(&left);
    return NULL;
  }
  PyObject *sides = PyTuple_GET_ITEM(args, 24);
  PyObject *idxs = PyTuple_GET_ITEM(args, 25);
  PyObject *addr_ov = PyTuple_GET_ITEM(args, 26);
  PyObject *file_ov = PyTuple_GET_ITEM(args, 27);
  PyObject *name_ov = PyTuple_GET_ITEM(args, 28);
  PyObject *prov_l = PyTuple_GET_ITEM(args, 29);
  PyObject *prov_r = PyTuple_GET_ITEM(args, 30);
  Factory fac;
  int fac_ok = factory_init(&fac, PyTuple_GET_ITEM(args, 31),
                            PyTuple_GET_ITEM(args, 32)) == 0;
  PyObject *out = NULL;
  if (!fac_ok) {
    factory_clear(&fac);
    release_stream(&left);
    release_stream(&right);
    return NULL;
  }
  Py_buffer sides_b = {0}, idxs_b = {0};
  if (PyObject_GetBuffer(sides, &sides_b, PyBUF_C_CONTIGUOUS) < 0) goto done0;
  if (PyObject_GetBuffer(idxs, &idxs_b, PyBUF_C_CONTIGUOUS) < 0) goto done1;
  {
    Py_ssize_t n = sides_b.len / 4;
    const int32_t *sd = (const int32_t *)sides_b.buf;
    const int32_t *ix = (const int32_t *)idxs_b.buf;
    if (idxs_b.len != sides_b.len ||
        !PyList_Check(addr_ov) || !PyList_Check(file_ov) ||
        !PyList_Check(name_ov) || PyList_GET_SIZE(addr_ov) != n ||
        PyList_GET_SIZE(file_ov) != n || PyList_GET_SIZE(name_ov) != n) {
      PyErr_SetString(PyExc_ValueError, "composed row arrays mismatch");
      goto done2;
    }
    out = PyList_New(n);
    if (!out) goto done2;
    for (Py_ssize_t i = 0; i < n; i++) {
      const Stream *s = (sd[i] == 0) ? &left.s : &right.s;
      Py_ssize_t row = ix[i];
      Py_ssize_t limit = (sd[i] == 0) ? left.n : right.n;
      if (row < 0 || row >= limit) {
        PyErr_SetString(PyExc_IndexError, "composed ref out of range");
        Py_CLEAR(out);
        goto done2;
      }
      PyObject *op = build_op(
          s, row, (sd[i] == 0) ? prov_l : prov_r, &fac,
          PyList_GET_ITEM(addr_ov, i), PyList_GET_ITEM(file_ov, i),
          PyList_GET_ITEM(name_ov, i));
      if (!op) {
        Py_CLEAR(out);
        goto done2;
      }
      PyList_SET_ITEM(out, i, op);
    }
  }
done2:
  PyBuffer_Release(&idxs_b);
done1:
  PyBuffer_Release(&sides_b);
done0:
  factory_clear(&fac);
  release_stream(&left);
  release_stream(&right);
  return out;
}

static PyMethodDef Methods[] = {
    {"stream_ops", py_stream_ops, METH_VARARGS,
     "Build one op stream's Op objects from its columns."},
    {"composed_ops", py_composed_ops, METH_VARARGS,
     "Build the composed Op sequence (any row range) from two streams' "
     "columns + per-row chain overrides."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                                       "semmerge_opfactory",
                                       NULL,
                                       -1,
                                       Methods,
                                       NULL,
                                       NULL,
                                       NULL,
                                       NULL};

static PyObject *intern(const char *s) { return PyUnicode_InternFromString(s); }

PyMODINIT_FUNC PyInit_semmerge_opfactory(void) {
  PyObject *m = PyModule_Create(&moduledef);
  if (!m) return NULL;
  S_id = intern("id");
  S_schemaVersion = intern("schemaVersion");
  S_type = intern("type");
  S_target = intern("target");
  S_params = intern("params");
  S_guards = intern("guards");
  S_effects = intern("effects");
  S_provenance = intern("provenance");
  S_symbolId = intern("symbolId");
  S_addressId = intern("addressId");
  S_oldName = intern("oldName");
  S_newName = intern("newName");
  S_file = intern("file");
  S_oldAddress = intern("oldAddress");
  S_newAddress = intern("newAddress");
  S_oldFile = intern("oldFile");
  S_newFile = intern("newFile");
  S_exists = intern("exists");
  S_addressMatch = intern("addressMatch");
  S_summary = intern("summary");
  S_renameContext = intern("renameContext");
  T_renameSymbol = intern("renameSymbol");
  T_moveDecl = intern("moveDecl");
  T_addDecl = intern("addDecl");
  T_deleteDecl = intern("deleteDecl");
  SUM_add = PyUnicode_FromString("add decl");
  SUM_del = PyUnicode_FromString("delete decl");
  SUM_ren_prefix = PyUnicode_FromString("rename ");
  SUM_mov_prefix = PyUnicode_FromString("move ");
  ARROW = PyUnicode_FromString("\xe2\x86\x92");
  ONE = PyLong_FromLong(1);
  return m;
}
