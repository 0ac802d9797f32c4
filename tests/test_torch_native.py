"""Port parity of the native scene runtime (accel/native.py, built by g++
from the port's own runtime/jade_native.cpp at first use):

- the SAH build equals the JAX package's native build array for array, on
  a 500-triangle soup and on the jade 20k scene;
- the port's default ``assemble`` on jade 20k gives the JAX package's
  default ``assemble(xp=np)`` tables (triangle order, mapping, BVH);
- the native OBJ parse equals the Python parse and the JAX native parse,
  with and without ``compat_slash_faces``;
- without a C++ compiler 'auto' falls back to NumPy and 'native' raises;
  a compile that fails raises.

Tolerance: none — exact array equality."""

import numpy as np
import pytest
import torch

from jaderaytracerendering_tpu.accel import native as jnative
from jaderaytracerendering_tpu.models import demo as jdemo
from jaderaytracerendering_tpu.scene import objloader as jobj
from jaderaytracerendering_tpu.scene.scene import assemble as jassemble
from jaderaytracerendering_tpu_torch.accel import native
from jaderaytracerendering_tpu_torch.models import demo as tdemo
from jaderaytracerendering_tpu_torch.scene import objloader, scene as tscene

torch.set_num_threads(1)

NODE_FIELDS = ("left", "right", "n", "index", "aa", "bb")
OBJ_TEXT = """# a mesh of every record the parsers read
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0.5
v 0.25 0.75 -1
vn 0 0 1
""" + "".join(f"v 0.5 0.{k} 1\n" for k in range(10)) + """
f 1 2 3
f 1/11/1 2/12/1 4/13/1
f 2 4 5 3
f -1 -2 -3
# trailing comment
"""


def _soup(n=500, seed=3):
    g = np.random.default_rng(seed)
    c = g.uniform(-1, 1, size=(n, 3))
    return tuple((c + g.normal(scale=0.05, size=(n, 3))).astype(np.float32) for _ in range(3))


def _jade20k_soup():
    ds = tdemo.jade_scene(n_buddha_tris=20_000)
    return tuple(np.concatenate([getattr(o.mesh, k) for o in ds.objects])
                 for k in ("p1", "p2", "p3"))


def test_native_source_is_the_ports_copy():
    assert native.SOURCE.parent.parent.name == "jaderaytracerendering_tpu_torch"
    jsrc = native.SOURCE.parents[2] / "jaderaytracerendering_tpu" / "runtime" / "jade_native.cpp"
    assert native.SOURCE.read_bytes() == jsrc.read_bytes()
    assert native.available() and native.library_path().parent.name == "build"


@pytest.mark.parametrize("soup", ["soup500", "jade20k"])
def test_native_build_equals_jax_native(soup):
    assert jnative.available()
    p1, p2, p3 = _soup() if soup == "soup500" else _jade20k_soup()
    tn, tp = native.build(p1, p2, p3, leaf_size=8, required=True)
    jn, jp = jnative.build(p1, p2, p3, leaf_size=8, required=True)
    np.testing.assert_array_equal(tp, jp)
    for k in NODE_FIELDS:
        a, b = getattr(tn, k), getattr(jn, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_default_assemble_equals_jax_default_on_jade20k():
    """Both packages' defaults take the native builder: the same triangle
    order, mapping and tree (the NumPy builder's order differs here)."""
    j = jdemo.jade_scene(n_buddha_tris=20_000)
    t = tdemo.jade_scene(n_buddha_tris=20_000)
    sj = jassemble(j.objects, j.env_map, xp=np)
    st = tscene.assemble(t.objects, t.env_map, device="cpu")
    assert st.bvh_builder == "native"
    for k in tscene.TABLES:
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k)),
                                      err_msg=k)
    assert st.n_nodes == sj.n_nodes and st.bvh_depth == sj.bvh_depth
    numpy_tree = tscene.assemble_numpy(t.objects, t.env_map, bvh_backend="numpy")
    assert numpy_tree["bvh_builder"] == "numpy"
    assert not np.array_equal(numpy_tree["mapping"], st.mapping.numpy())


@pytest.mark.parametrize("compat", [False, True])
def test_native_obj_parse_matches_python_and_jax(tmp_path, compat):
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT)
    v, f = native.parse_obj(str(path), compat_slash_faces=compat)
    pv, pf = objloader.parse_obj_text(OBJ_TEXT, compat_slash_faces=compat)
    jv, jf = jnative.parse_obj(str(path), compat_slash_faces=compat)
    assert f.shape == (4 if compat else 5, 3)  # compat: three ints a face record
    for a, b in ((v, pv), (f, pf), (v, jv), (f, jf)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    meshes = [objloader.read_obj(str(path), compat_slash_faces=compat, backend=b)
              for b in ("auto", "native", "python")]
    want = jobj.read_obj(str(path), compat_slash_faces=compat, backend="native")
    for m in meshes:
        for k in ("p1", "p2", "p3", "norm"):
            np.testing.assert_array_equal(getattr(m, k), getattr(want, k))
    with pytest.raises(ValueError):
        objloader.read_obj(str(path), backend="fortran")


def _no_library(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_checked", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)


def test_native_backend_raises_without_compiler(monkeypatch, tmp_path):
    _no_library(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "find_compiler", lambda: None)
    ds = tdemo.tiny_scene()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tscene.assemble(ds.objects, ds.env_map, bvh_backend="native", device="cpu")
    st = tscene.assemble(ds.objects, ds.env_map, device="cpu")
    assert st.bvh_builder == "numpy" and not native.available()
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_TEXT)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        objloader.read_obj(str(path), backend="native")
    assert objloader.read_obj(str(path)).n_triangles == 5
    with pytest.raises(ValueError):
        tscene.assemble(ds.objects, ds.env_map, bvh_backend="embree", device="cpu")


def test_native_compile_failure_raises(monkeypatch, tmp_path):
    _no_library(monkeypatch, tmp_path)
    bad = tmp_path / "jade_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.available()
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("backend", ["auto", "numpy"])
def test_render_cli_reports_its_bvh_builder(monkeypatch, tmp_path, backend):
    """The render CLI builds with the JAX CLI's default (native), falls
    back to NumPy where no C++ compiler builds the library, and reports
    which builder ran."""
    from jaderaytracerendering_tpu_torch.cli import render

    if backend == "numpy":
        _no_library(monkeypatch, tmp_path)
        monkeypatch.setattr(native, "find_compiler", lambda: None)
    argv = ["--device", "cpu", "--scene", "tiny", "--width", "4", "--height", "4", "--spp",
            "1", "--max-depth", "2", "--out", str(tmp_path / "out.bmp")]
    _, stats = render.main(argv)
    assert stats["bvh_builder"] == backend.replace("auto", "native")
    assert stats["scene_build_s"] > 0
