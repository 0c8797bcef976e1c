/* CPython fast path for the interactive PettingZoo dict API (batch=1).
 *
 * The pure-Python adapter costs ~3.5-4us of object plumbing per step on top
 * of the ~1-4us native frame: dict unpacking, two defensive numpy copies,
 * five result dicts.  This extension performs the WHOLE dict-API step in one
 * native call — parse the actions dict, run the C++ engine's
 * pika_step_obs_batch (dlopen'd from the same pika_engine.so the ctypes
 * bindings build), materialize fresh (35,) int32 observation arrays, and
 * build the five PettingZoo result dicts with the C API.
 *
 * Semantics mirror compat/parallel_env.raw_env.step exactly (same dict
 * shapes, fresh per-step inner dicts, the SHARED mutable scores list the
 * reference exposes through infos — pikazoo_env.py:573-574); equality is
 * pinned by tests/test_native_engine.py::test_fastpath_matches_python_adapter.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

typedef void (*step_obs_fn)(int32_t *, const int32_t *, const int32_t *,
                            int32_t *, uint8_t *, int32_t *, int, int, int,
                            int, int, int, int);

typedef struct {
    PyObject_HEAD
    void *dl;
    step_obs_fn step_obs;
    PyObject *state_owner;   /* the (1, NFIELDS) int32 matrix (keeps data alive) */
    int32_t *state;
    PyObject *scores_list;   /* the adapter's shared mutable [s1, s2] */
    PyObject *p1_name, *p2_name;
    int winning_score, serve_mode, p1c, p2c, auto_reset;
    int score1_col, score2_col;
    int32_t actions[2];
    int32_t rewards[2];
    int32_t obs[70];
    int32_t oracle[1];
    uint8_t flags;
} FastStepper;

static void FastStepper_dealloc(FastStepper *self) {
    Py_XDECREF(self->state_owner);
    Py_XDECREF(self->scores_list);
    Py_XDECREF(self->p1_name);
    Py_XDECREF(self->p2_name);
    if (self->dl) dlclose(self->dl);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static int FastStepper_init(FastStepper *self, PyObject *args,
                            PyObject *kwds) {
    const char *so_path;
    PyObject *state_arr, *scores;
    if (!PyArg_ParseTuple(args, "sO!O!iiiiiii", &so_path, &PyArray_Type,
                          &state_arr, &PyList_Type, &scores,
                          &self->winning_score, &self->serve_mode,
                          &self->p1c, &self->p2c, &self->auto_reset,
                          &self->score1_col, &self->score2_col))
        return -1;
    PyArrayObject *st = (PyArrayObject *)state_arr;
    if (PyArray_TYPE(st) != NPY_INT32 || !PyArray_IS_C_CONTIGUOUS(st)) {
        PyErr_SetString(PyExc_ValueError,
                        "state must be C-contiguous int32");
        return -1;
    }
    self->dl = dlopen(so_path, RTLD_NOW | RTLD_LOCAL);
    if (!self->dl) {
        PyErr_Format(PyExc_OSError, "dlopen(%s): %s", so_path, dlerror());
        return -1;
    }
    self->step_obs = (step_obs_fn)dlsym(self->dl, "pika_step_obs_batch");
    if (!self->step_obs) {
        PyErr_SetString(PyExc_OSError, "pika_step_obs_batch not found");
        return -1;
    }
    Py_INCREF(state_arr);
    self->state_owner = state_arr;
    self->state = (int32_t *)PyArray_DATA(st);
    Py_INCREF(scores);
    self->scores_list = scores;
    self->p1_name = PyUnicode_InternFromString("player_1");
    self->p2_name = PyUnicode_InternFromString("player_2");
    if (!self->p1_name || !self->p2_name) return -1;
    self->oracle[0] = 0;
    return 0;
}

static PyObject *two_dict(PyObject *p1n, PyObject *p2n, PyObject *v1,
                          PyObject *v2) {
    /* steals v1/v2 on success or failure */
    PyObject *d = PyDict_New();
    if (!d || !v1 || !v2 || PyDict_SetItem(d, p1n, v1) < 0 ||
        PyDict_SetItem(d, p2n, v2) < 0) {
        Py_XDECREF(d);
        Py_XDECREF(v1);
        Py_XDECREF(v2);
        return NULL;
    }
    Py_DECREF(v1);
    Py_DECREF(v2);
    return d;
}

static int as_action(PyObject *o, long *out) {
    /* int(o) semantics — the same conversion the Python fallback applies
     * (parallel_env.py int(actions[...])): exact ints fast-path, then
     * PyNumber_Long for numpy scalars / floats (truncating) / __int__.
     * Each operand carries its own error check so the CPython API is never
     * entered with a pending exception. */
    long v = PyLong_AsLong(o);
    if (v == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        PyObject *i = PyNumber_Long(o);
        if (!i)
            return -1;
        v = PyLong_AsLong(i);
        Py_DECREF(i);
        if (v == -1 && PyErr_Occurred())
            return -1;
    }
    *out = v;
    return 0;
}

static PyObject *FastStepper_step(FastStepper *self, PyObject *actions) {
    if (!PyDict_Check(actions)) {
        PyErr_SetString(PyExc_TypeError, "actions must be a dict");
        return NULL;
    }
    PyObject *a1 = PyDict_GetItem(actions, self->p1_name);  /* borrowed */
    PyObject *a2 = PyDict_GetItem(actions, self->p2_name);
    if (!a1 || !a2) {
        PyErr_SetString(PyExc_KeyError, "actions need player_1/player_2");
        return NULL;
    }
    long la1, la2;
    if (as_action(a1, &la1) < 0 || as_action(a2, &la2) < 0)
        return NULL;
    self->actions[0] = (int32_t)la1;
    self->actions[1] = (int32_t)la2;

    self->step_obs(self->state, self->actions, self->oracle, self->rewards,
                   &self->flags, self->obs, 1, self->winning_score,
                   self->serve_mode, self->p1c, self->p2c, self->auto_reset,
                   0);

    long r1 = 0;
    int terminated = self->flags & 1;
    if (self->flags & 2) {  /* scores only change on round-end frames */
        r1 = self->rewards[0];
        PyObject *s1 = PyLong_FromLong(self->state[self->score1_col]);
        PyObject *s2 = PyLong_FromLong(self->state[self->score2_col]);
        if (!s1 || !s2) {
            Py_XDECREF(s1);
            Py_XDECREF(s2);
            return NULL;
        }
        if (PyList_SetItem(self->scores_list, 0, s1) < 0) {  /* steals s1 */
            Py_DECREF(s2);
            return NULL;
        }
        if (PyList_SetItem(self->scores_list, 1, s2) < 0)    /* steals s2 */
            return NULL;
    }

    npy_intp dims[1] = {35};
    PyObject *o1 = PyArray_SimpleNew(1, dims, NPY_INT32);
    PyObject *o2 = PyArray_SimpleNew(1, dims, NPY_INT32);
    if (!o1 || !o2) { Py_XDECREF(o1); Py_XDECREF(o2); return NULL; }
    memcpy(PyArray_DATA((PyArrayObject *)o1), self->obs, 35 * 4);
    memcpy(PyArray_DATA((PyArrayObject *)o2), self->obs + 35, 35 * 4);

    PyObject *obs_d = two_dict(self->p1_name, self->p2_name, o1, o2);
    PyObject *rew_d = two_dict(self->p1_name, self->p2_name,
                               PyLong_FromLong(r1), PyLong_FromLong(-r1));
    PyObject *term = PyBool_FromLong(terminated);
    Py_INCREF(term);
    PyObject *term_d = two_dict(self->p1_name, self->p2_name, term, term);
    Py_INCREF(Py_False);
    Py_INCREF(Py_False);
    PyObject *trunc_d = two_dict(self->p1_name, self->p2_name, Py_False,
                                 Py_False);
    PyObject *i1 = PyDict_New(), *i2 = PyDict_New();
    PyObject *info_d = NULL;
    if (i1 && i2 &&
        PyDict_SetItemString(i1, "score", self->scores_list) == 0 &&
        PyDict_SetItemString(i2, "score", self->scores_list) == 0)
        info_d = two_dict(self->p1_name, self->p2_name, i1, i2);
    else {
        Py_XDECREF(i1);
        Py_XDECREF(i2);
    }
    if (!obs_d || !rew_d || !term_d || !trunc_d || !info_d) {
        Py_XDECREF(obs_d);
        Py_XDECREF(rew_d);
        Py_XDECREF(term_d);
        Py_XDECREF(trunc_d);
        Py_XDECREF(info_d);
        return NULL;
    }
    /* (obs, rewards, terminations, truncations, infos, flags) — the caller
       handles agent-list emptying and rendering from flags. */
    PyObject *flags_obj = PyLong_FromLong(self->flags);
    PyObject *out = flags_obj ? PyTuple_New(6) : NULL;
    if (!out) {
        Py_XDECREF(flags_obj);
        Py_DECREF(obs_d);
        Py_DECREF(rew_d);
        Py_DECREF(term_d);
        Py_DECREF(trunc_d);
        Py_DECREF(info_d);
        return NULL;
    }
    PyTuple_SET_ITEM(out, 0, obs_d);
    PyTuple_SET_ITEM(out, 1, rew_d);
    PyTuple_SET_ITEM(out, 2, term_d);
    PyTuple_SET_ITEM(out, 3, trunc_d);
    PyTuple_SET_ITEM(out, 4, info_d);
    PyTuple_SET_ITEM(out, 5, flags_obj);
    return out;
}

static PyMethodDef FastStepper_methods[] = {
    {"step", (PyCFunction)FastStepper_step, METH_O,
     "One dict-API frame: actions dict -> (obs, rewards, terminations, "
     "truncations, infos, flags)."},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject FastStepperType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "_pika_fastpath.FastStepper",
    .tp_basicsize = sizeof(FastStepper),
    .tp_dealloc = (destructor)FastStepper_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Native batch=1 PettingZoo dict-API stepper",
    .tp_methods = FastStepper_methods,
    .tp_init = (initproc)FastStepper_init,
    .tp_new = PyType_GenericNew,
};

static PyModuleDef fastpath_module = {
    PyModuleDef_HEAD_INIT, "_pika_fastpath",
    "Native interactive dict-API step", -1, NULL,
};

PyMODINIT_FUNC PyInit__pika_fastpath(void) {
    import_array();
    if (PyType_Ready(&FastStepperType) < 0) return NULL;
    PyObject *m = PyModule_Create(&fastpath_module);
    if (!m) return NULL;
    Py_INCREF(&FastStepperType);
    if (PyModule_AddObject(m, "FastStepper",
                           (PyObject *)&FastStepperType) < 0) {
        Py_DECREF(&FastStepperType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
