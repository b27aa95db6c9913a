// Native slot registry: id <-> slot bookkeeping for the vector store.
//
// The TPU owns scoring; the host owns string-id bookkeeping. At 10M+
// vectors the reference-style per-id Python dict churn (reference
// wdbx/core/indexing.py:254-256 id_to_index/index_to_id maps) dominates
// ingest wall time, so this is the one genuinely hot host path worth
// native code. C++ unordered_map + contiguous reverse vector + LIFO
// free list, exposed through the CPython C API (pybind11 is not in this
// image). Python fallback lives in wdbx_tpu_torch/native/__init__.py.
//
// Build: make -C wdbx_tpu_torch/native   (g++ -O2 -shared -fPIC)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Registry {
    PyObject_HEAD
    std::unordered_map<std::string, int64_t>* id_to_slot;
    std::vector<std::string>* slot_to_id;  // empty string == unused
    std::vector<int64_t>* free_slots;
    int64_t next_slot;
};

void registry_dealloc(PyObject* self) {
    Registry* r = reinterpret_cast<Registry*>(self);
    delete r->id_to_slot;
    delete r->slot_to_id;
    delete r->free_slots;
    Py_TYPE(self)->tp_free(self);
}

PyObject* registry_new(PyTypeObject* type, PyObject*, PyObject*) {
    Registry* r = reinterpret_cast<Registry*>(type->tp_alloc(type, 0));
    if (r == nullptr) return nullptr;
    r->id_to_slot = new std::unordered_map<std::string, int64_t>();
    r->slot_to_id = new std::vector<std::string>();
    r->free_slots = new std::vector<int64_t>();
    r->next_slot = 0;
    return reinterpret_cast<PyObject*>(r);
}

// helper: build a 2-tuple stealing both references
PyObject* PyTuple_Pack2Steal(PyObject* a, PyObject* b) {
    PyObject* t = PyTuple_New(2);
    if (t == nullptr) { Py_DECREF(a); Py_DECREF(b); return nullptr; }
    PyTuple_SET_ITEM(t, 0, a);
    PyTuple_SET_ITEM(t, 1, b);
    return t;
}

// assign(ids: list[str]) -> (slots: list[int], fresh: list[bool])
// Existing ids keep their slot (fresh=False → caller updates in place);
// new ids pop the free list, then extend the high-water mark.
PyObject* registry_assign(PyObject* self, PyObject* args) {
    PyObject* ids;
    if (!PyArg_ParseTuple(args, "O", &ids)) return nullptr;
    PyObject* seq = PySequence_Fast(ids, "assign() expects a sequence");
    if (seq == nullptr) return nullptr;
    Registry* r = reinterpret_cast<Registry*>(self);
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

    PyObject* slots = PyList_New(n);
    PyObject* fresh = PyList_New(n);
    if (slots == nullptr || fresh == nullptr) {
        Py_XDECREF(slots); Py_XDECREF(fresh); Py_DECREF(seq);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        Py_ssize_t len;
        const char* data = PyUnicode_AsUTF8AndSize(item, &len);
        if (data == nullptr) {
            Py_DECREF(slots); Py_DECREF(fresh); Py_DECREF(seq);
            return nullptr;
        }
        std::string key(data, static_cast<size_t>(len));
        auto it = r->id_to_slot->find(key);
        int64_t slot;
        bool is_fresh;
        if (it != r->id_to_slot->end()) {
            slot = it->second;
            is_fresh = false;
        } else {
            if (!r->free_slots->empty()) {
                slot = r->free_slots->back();
                r->free_slots->pop_back();
            } else {
                slot = r->next_slot++;
            }
            if (static_cast<size_t>(slot) >= r->slot_to_id->size())
                r->slot_to_id->resize(static_cast<size_t>(slot) + 1);
            (*r->slot_to_id)[static_cast<size_t>(slot)] = key;
            (*r->id_to_slot)[std::move(key)] = slot;
            is_fresh = true;
        }
        PyList_SET_ITEM(slots, i, PyLong_FromLongLong(slot));
        PyObject* flag = is_fresh ? Py_True : Py_False;
        Py_INCREF(flag);
        PyList_SET_ITEM(fresh, i, flag);
    }
    Py_DECREF(seq);
    return PyTuple_Pack2Steal(slots, fresh);
}

// put(ids: seq[str], slots: seq[int]) — insert/overwrite mappings with
// slots allocated elsewhere (the device index owns slot lifecycle).
PyObject* registry_put(PyObject* self, PyObject* args) {
    PyObject* ids;
    PyObject* slots;
    if (!PyArg_ParseTuple(args, "OO", &ids, &slots)) return nullptr;
    Registry* r = reinterpret_cast<Registry*>(self);
    PyObject* iseq = PySequence_Fast(ids, "put() ids");
    if (iseq == nullptr) return nullptr;
    PyObject* sseq = PySequence_Fast(slots, "put() slots");
    if (sseq == nullptr) { Py_DECREF(iseq); return nullptr; }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(iseq);
    if (PySequence_Fast_GET_SIZE(sseq) != n) {
        Py_DECREF(iseq); Py_DECREF(sseq);
        PyErr_SetString(PyExc_ValueError, "ids/slots length mismatch");
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_Fast_GET_ITEM(iseq, i);
        Py_ssize_t len;
        const char* data = PyUnicode_AsUTF8AndSize(item, &len);
        if (data == nullptr) { Py_DECREF(iseq); Py_DECREF(sseq); return nullptr; }
        long long slot = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(sseq, i));
        if (slot == -1 && PyErr_Occurred()) {
            Py_DECREF(iseq); Py_DECREF(sseq); return nullptr;
        }
        if (slot < 0) {
            Py_DECREF(iseq); Py_DECREF(sseq);
            PyErr_SetString(PyExc_ValueError, "slot ids must be >= 0");
            return nullptr;
        }
        if (len == 0) {
            // the empty string doubles as the internal unused-slot
            // marker; reject it so semantics match PySlotRegistry
            Py_DECREF(iseq); Py_DECREF(sseq);
            PyErr_SetString(PyExc_ValueError, "vector ids must be non-empty");
            return nullptr;
        }
        std::string key(data, static_cast<size_t>(len));
        if (static_cast<size_t>(slot) >= r->slot_to_id->size())
            r->slot_to_id->resize(static_cast<size_t>(slot) + 1);
        (*r->slot_to_id)[static_cast<size_t>(slot)] = key;
        (*r->id_to_slot)[std::move(key)] = slot;
        if (slot >= r->next_slot) r->next_slot = slot + 1;
    }
    Py_DECREF(iseq);
    Py_DECREF(sseq);
    Py_RETURN_NONE;
}

PyObject* registry_lookup(PyObject* self, PyObject* args) {
    const char* id;
    Py_ssize_t len;
    if (!PyArg_ParseTuple(args, "s#", &id, &len)) return nullptr;
    Registry* r = reinterpret_cast<Registry*>(self);
    auto it = r->id_to_slot->find(std::string(id, static_cast<size_t>(len)));
    if (it == r->id_to_slot->end()) Py_RETURN_NONE;
    return PyLong_FromLongLong(it->second);
}

PyObject* registry_id_of(PyObject* self, PyObject* args) {
    long long slot;
    if (!PyArg_ParseTuple(args, "L", &slot)) return nullptr;
    Registry* r = reinterpret_cast<Registry*>(self);
    if (slot < 0 || static_cast<size_t>(slot) >= r->slot_to_id->size())
        Py_RETURN_NONE;
    const std::string& s = (*r->slot_to_id)[static_cast<size_t>(slot)];
    if (s.empty()) Py_RETURN_NONE;
    return PyUnicode_FromStringAndSize(s.data(), static_cast<Py_ssize_t>(s.size()));
}

// remove(id) -> slot | None ; frees the slot for reuse
PyObject* registry_remove(PyObject* self, PyObject* args) {
    const char* id;
    Py_ssize_t len;
    if (!PyArg_ParseTuple(args, "s#", &id, &len)) return nullptr;
    Registry* r = reinterpret_cast<Registry*>(self);
    auto it = r->id_to_slot->find(std::string(id, static_cast<size_t>(len)));
    if (it == r->id_to_slot->end()) Py_RETURN_NONE;
    int64_t slot = it->second;
    (*r->slot_to_id)[static_cast<size_t>(slot)].clear();
    r->id_to_slot->erase(it);
    r->free_slots->push_back(slot);
    return PyLong_FromLongLong(slot);
}

PyObject* registry_len(PyObject* self, PyObject*) {
    Registry* r = reinterpret_cast<Registry*>(self);
    return PyLong_FromSsize_t(static_cast<Py_ssize_t>(r->id_to_slot->size()));
}

PyObject* registry_contains(PyObject* self, PyObject* args) {
    const char* id;
    Py_ssize_t len;
    if (!PyArg_ParseTuple(args, "s#", &id, &len)) return nullptr;
    Registry* r = reinterpret_cast<Registry*>(self);
    bool found =
        r->id_to_slot->count(std::string(id, static_cast<size_t>(len))) > 0;
    if (found) Py_RETURN_TRUE;
    Py_RETURN_FALSE;
}

// items() -> list[(id, slot)] for persistence snapshots
PyObject* registry_items(PyObject* self, PyObject*) {
    Registry* r = reinterpret_cast<Registry*>(self);
    PyObject* out = PyList_New(static_cast<Py_ssize_t>(r->id_to_slot->size()));
    if (out == nullptr) return nullptr;
    Py_ssize_t i = 0;
    for (const auto& kv : *r->id_to_slot) {
        PyObject* pair = Py_BuildValue("(s#L)", kv.first.data(),
                                       static_cast<Py_ssize_t>(kv.first.size()),
                                       static_cast<long long>(kv.second));
        if (pair == nullptr) { Py_DECREF(out); return nullptr; }
        PyList_SET_ITEM(out, i++, pair);
    }
    return out;
}

// load(items: list[(id, slot)], next_slot: int, free: list[int])
PyObject* registry_load(PyObject* self, PyObject* args) {
    PyObject* items;
    long long next_slot;
    PyObject* free_list;
    if (!PyArg_ParseTuple(args, "OLO", &items, &next_slot, &free_list))
        return nullptr;
    Registry* r = reinterpret_cast<Registry*>(self);
    r->id_to_slot->clear();
    r->slot_to_id->clear();
    r->free_slots->clear();
    r->next_slot = next_slot;
    r->slot_to_id->resize(static_cast<size_t>(next_slot));
    PyObject* seq = PySequence_Fast(items, "load() expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* pair = PySequence_Fast_GET_ITEM(seq, i);
        const char* id;
        Py_ssize_t len;
        long long slot;
        if (!PyArg_ParseTuple(pair, "s#L", &id, &len, &slot)) {
            Py_DECREF(seq);
            return nullptr;
        }
        if (slot < 0 || len == 0) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_ValueError,
                            "corrupt registry snapshot: negative slot "
                            "or empty id");
            return nullptr;
        }
        std::string key(id, static_cast<size_t>(len));
        if (static_cast<size_t>(slot) >= r->slot_to_id->size())
            r->slot_to_id->resize(static_cast<size_t>(slot) + 1);
        (*r->slot_to_id)[static_cast<size_t>(slot)] = key;
        (*r->id_to_slot)[std::move(key)] = slot;
    }
    Py_DECREF(seq);
    PyObject* fseq = PySequence_Fast(free_list, "load() free list");
    if (fseq == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(fseq); i++) {
        long long fs = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(fseq, i));
        if ((fs == -1 && PyErr_Occurred()) || fs < 0) {
            Py_DECREF(fseq);
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_ValueError,
                                "corrupt registry snapshot: bad free slot");
            return nullptr;
        }
        r->free_slots->push_back(fs);
    }
    Py_DECREF(fseq);
    Py_RETURN_NONE;
}

PyObject* registry_state(PyObject* self, PyObject*) {
    Registry* r = reinterpret_cast<Registry*>(self);
    PyObject* free_list =
        PyList_New(static_cast<Py_ssize_t>(r->free_slots->size()));
    for (size_t i = 0; i < r->free_slots->size(); i++)
        PyList_SET_ITEM(free_list, static_cast<Py_ssize_t>(i),
                        PyLong_FromLongLong((*r->free_slots)[i]));
    return Py_BuildValue("(LN)", static_cast<long long>(r->next_slot),
                         free_list);
}

// id_table() -> list[str | None] of length next_slot: slot -> id, with
// None for free/unused slots. Feeds the store's vectorized slot->id
// resolution (np.array(..., dtype=object)) in one C pass instead of a
// per-entry Python loop over items() — the loop costs seconds at 10M
// ids and sits on the first search after any mutation.
PyObject* registry_id_table(PyObject* self, PyObject*) {
    Registry* r = reinterpret_cast<Registry*>(self);
    Py_ssize_t n = static_cast<Py_ssize_t>(r->slot_to_id->size());
    PyObject* out = PyList_New(n);
    if (out == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < n; i++) {
        const std::string& s = (*r->slot_to_id)[static_cast<size_t>(i)];
        PyObject* item;
        if (s.empty()) {
            item = Py_None;
            Py_INCREF(item);
        } else {
            item = PyUnicode_FromStringAndSize(
                s.data(), static_cast<Py_ssize_t>(s.size()));
            if (item == nullptr) { Py_DECREF(out); return nullptr; }
        }
        PyList_SET_ITEM(out, i, item);
    }
    return out;
}

PyMethodDef registry_methods[] = {
    {"assign", registry_assign, METH_VARARGS,
     "assign(ids) -> (slots, fresh_flags)"},
    {"put", registry_put, METH_VARARGS, "put(ids, slots)"},
    {"lookup", registry_lookup, METH_VARARGS, "lookup(id) -> slot | None"},
    {"id_of", registry_id_of, METH_VARARGS, "id_of(slot) -> id | None"},
    {"remove", registry_remove, METH_VARARGS, "remove(id) -> slot | None"},
    {"size", registry_len, METH_NOARGS, "size() -> int"},
    {"contains", registry_contains, METH_VARARGS, "contains(id) -> bool"},
    {"items", registry_items, METH_NOARGS, "items() -> list[(id, slot)]"},
    {"load", registry_load, METH_VARARGS, "load(items, next_slot, free)"},
    {"state", registry_state, METH_NOARGS, "state() -> (next_slot, free)"},
    {"id_table", registry_id_table, METH_NOARGS,
     "id_table() -> list[id | None] indexed by slot"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject RegistryType = [] {
    PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0)};
    t.tp_name = "_native.SlotRegistry";
    t.tp_basicsize = sizeof(Registry);
    t.tp_flags = Py_TPFLAGS_DEFAULT;
    t.tp_doc = PyDoc_STR("Native id<->slot registry");
    t.tp_new = registry_new;
    t.tp_dealloc = registry_dealloc;
    t.tp_methods = registry_methods;
    return t;
}();

PyModuleDef native_module = {
    PyModuleDef_HEAD_INIT, "_native",
    "Native host-side bookkeeping for wdbx_tpu_torch", -1, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
    if (PyType_Ready(&RegistryType) < 0) return nullptr;
    PyObject* m = PyModule_Create(&native_module);
    if (m == nullptr) return nullptr;
    Py_INCREF(&RegistryType);
    if (PyModule_AddObject(m, "SlotRegistry",
                           reinterpret_cast<PyObject*>(&RegistryType)) < 0) {
        Py_DECREF(&RegistryType);
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
