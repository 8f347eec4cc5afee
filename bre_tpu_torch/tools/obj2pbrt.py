"""obj2pbrt: Wavefront OBJ -> .pbrt converter, the same output text, byte for
byte, as ``bre_tpu/tools/obj2pbrt.py`` (pbrt's src/tools/obj2pbrt.cpp):

- vertex normals ("normal N") and texture coordinates ("float st") are
  carried through, with per-face index triples remapped to unified vertices;
- .mtl materials become ``MakeNamedMaterial "<name>" "string type" "uber"``
  (Kd/Ks colors or imagemap textures with scale composition, roughness =
  1/shininess, Kt, index, opacity, bumpmap) as pbrt's tool emits them;
- each OBJ group/object becomes an AttributeBegin block, split into one
  trianglemesh per material id used by its faces; emissive materials (Ke)
  emit ``AreaLightSource "area"`` before the shape (obj2pbrt.cpp:1447-1451).

Text in, text out: no tensor work, so no device.
Usage: ``python -m bre_tpu_torch.tools.obj2pbrt in.obj out.pbrt``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


class _Mtl:
    def __init__(self, name):
        self.name = name
        self.diffuse = (0.0, 0.0, 0.0)
        self.specular = (0.0, 0.0, 0.0)
        self.transmittance = (0.0, 0.0, 0.0)
        self.emission = (0.0, 0.0, 0.0)
        self.shininess = 0.0
        self.ior = 1.0
        self.dissolve = 1.0
        self.diffuse_texname = ""
        self.specular_texname = ""
        self.bump_texname = ""


def _parse_mtl(path: Path):
    mtls = []
    cur = None
    if not path.exists():
        return mtls
    for line in path.read_text().splitlines():
        t = line.split()
        if not t or t[0].startswith("#"):
            continue
        k = t[0]
        if k == "newmtl":
            cur = _Mtl(t[1] if len(t) > 1 else "")
            mtls.append(cur)
        elif cur is None:
            continue
        elif k == "Kd":
            cur.diffuse = tuple(float(x) for x in t[1:4])
        elif k == "Ks":
            cur.specular = tuple(float(x) for x in t[1:4])
        elif k == "Tf":
            cur.transmittance = tuple(float(x) for x in t[1:4])
        elif k == "Ke":
            cur.emission = tuple(float(x) for x in t[1:4])
        elif k == "Ns":
            cur.shininess = float(t[1])
        elif k == "Ni":
            cur.ior = float(t[1])
        elif k == "d":
            cur.dissolve = float(t[1])
        elif k == "Tr":  # some exporters write transparency instead of d
            cur.dissolve = 1.0 - float(t[1])
        elif k == "map_Kd":
            cur.diffuse_texname = t[-1]
        elif k == "map_Ks":
            cur.specular_texname = t[-1]
        elif k in ("map_bump", "map_Bump", "bump"):
            cur.bump_texname = t[-1]
    return mtls


def _resolve(idx: int, n: int) -> int:
    return idx - 1 if idx > 0 else n + idx


def obj_to_pbrt(obj_path, out_path) -> int:
    obj_path = Path(obj_path)
    positions, normals, texcoords = [], [], []
    materials, mtl_index = [], {}
    # shapes: list of (name, faces) with faces = [(mat_id, [(v,vt,vn)x3])]
    shapes = [["", []]]
    cur_mat = -1
    for line in obj_path.read_text().splitlines():
        t = line.split()
        if not t or t[0].startswith("#"):
            continue
        k = t[0]
        if k == "v":
            positions.append(tuple(float(x) for x in t[1:4]))
        elif k == "vn":
            normals.append(tuple(float(x) for x in t[1:4]))
        elif k == "vt":
            texcoords.append(tuple(float(x) for x in t[1:3]))
        elif k == "mtllib":
            for m in _parse_mtl(obj_path.parent / t[1]):
                mtl_index[m.name] = len(materials)
                materials.append(m)
        elif k == "usemtl":
            cur_mat = mtl_index.get(t[1] if len(t) > 1 else "", -1)
        elif k in ("g", "o"):
            name = " ".join(t[1:])
            if shapes[-1][1]:
                shapes.append([name, []])
            else:
                shapes[-1][0] = name
        elif k == "f":
            tri = []
            for vstr in t[1:]:
                parts = vstr.split("/")
                vi = _resolve(int(parts[0]), len(positions))
                ti = (_resolve(int(parts[1]), len(texcoords))
                      if len(parts) > 1 and parts[1] else -1)
                ni = (_resolve(int(parts[2]), len(normals))
                      if len(parts) > 2 and parts[2] else -1)
                tri.append((vi, ti, ni))
            for j in range(1, len(tri) - 1):  # fan triangulation
                shapes[-1][1].append((cur_mat, [tri[0], tri[j], tri[j + 1]]))

    lo = [min((p[c] for p in positions), default=0.0) for c in range(3)]
    hi = [max((p[c] for p in positions), default=0.0) for c in range(3)]

    n_tris = n_lights = 0
    with open(out_path, "w") as f:
        f.write(f'# Converted from "{obj_path}" by obj2pbrt\n')
        f.write(f"# Scene bounds: ({lo[0]:f}, {lo[1]:f}, {lo[2]:f}) - "
                f"({hi[0]:f}, {hi[1]:f}, {hi[2]:f})\n\n\n")

        for m in materials:
            if m.diffuse_texname:
                if any(m.diffuse):
                    f.write(f'Texture "{m.name}-kd-img" "color" "imagemap" '
                            f'"string filename" ["{m.diffuse_texname}"]\n')
                    f.write(f'Texture "{m.name}-kd" "color" "scale" '
                            f'"texture tex1" "{m.name}-kd-img" "color tex2" '
                            f"[{m.diffuse[0]:f} {m.diffuse[1]:f} "
                            f"{m.diffuse[2]:f}]\n")
                else:
                    f.write(f'Texture "{m.name}-kd" "color" "imagemap" '
                            f'"string filename" ["{m.diffuse_texname}"]\n')
            if m.specular_texname:
                if any(m.specular):
                    f.write(f'Texture "{m.name}-ks-img" "color" "imagemap" '
                            f'"string filename" ["{m.specular_texname}"]\n')
                    f.write(f'Texture "{m.name}-ks" "color" "scale" '
                            f'"texture tex1" "{m.name}-ks-img" "color tex2" '
                            f"[{m.specular[0]:f} {m.specular[1]:f} "
                            f"{m.specular[2]:f}]\n")
                else:
                    f.write(f'Texture "{m.name}-ks" "color" "imagemap" '
                            f'"string filename" ["{m.specular_texname}"]\n')
            if m.bump_texname:
                f.write(f'Texture "{m.name}-bump" "float" "imagemap" '
                        f'"string filename" ["{m.bump_texname}"]\n')
            rough = 0.0 if m.shininess == 0 else 1.0 / m.shininess
            f.write(f'MakeNamedMaterial "{m.name}" "string type" "uber" ')
            if m.diffuse_texname:
                f.write(f'"texture Kd" "{m.name}-kd" ')
            else:
                f.write(f'"color Kd" [{m.diffuse[0]:f} {m.diffuse[1]:f} '
                        f"{m.diffuse[2]:f}] ")
            if m.specular_texname:
                f.write(f'"texture Ks" "{m.name}-ks" ')
            else:
                f.write(f'"color Ks" [{m.specular[0]:f} {m.specular[1]:f} '
                        f"{m.specular[2]:f}] ")
            f.write(f'"float roughness" [{rough:f}] '
                    f'"rgb Kt" [{m.transmittance[0]:f} '
                    f"{m.transmittance[1]:f} {m.transmittance[2]:f}] "
                    f'"float index" [{m.ior:f}] '
                    f'"rgb opacity" [{m.dissolve:f} {m.dissolve:f} '
                    f"{m.dissolve:f}] ")
            if m.bump_texname:
                f.write(f'"texture bumpmap" "{m.name}-bump" ')
            f.write("\n\n")

        for name, faces in shapes:
            if not faces:
                continue
            f.write(f'# Name "{name}"\n')
            f.write("AttributeBegin\n")
            for mid in sorted(set(mf[0] for mf in faces)):
                if mid == -1:
                    f.write("# Material unspecified in OBJ file\n")
                else:
                    m = materials[mid]
                    if any(m.emission):
                        f.write(f'AreaLightSource "area" "rgb L" '
                                f"[ {m.emission[0]:f} {m.emission[1]:f} "
                                f"{m.emission[2]:f} ]\n")
                        n_lights += 1
                    f.write(f'NamedMaterial "{m.name}"\n')
                remap = {}
                P, N, st, idx = [], [], [], []
                for fm, tri in faces:
                    if fm != mid:
                        continue
                    n_tris += 1
                    for key in tri:
                        if key not in remap:
                            remap[key] = len(remap)
                            vi, ti, ni = key
                            P.append("%.10g %.10g %.10g" % positions[vi])
                            if ni >= 0:
                                N.append("%.10g %.10g %.10g" % normals[ni])
                            if ti >= 0:
                                st.append("%.10g %.10g" % texcoords[ti])
                        idx.append(str(remap[key]))
                f.write('Shape "trianglemesh"\n')
                f.write(f'  "point P" [ {" ".join(P)} ]\n')
                if N:
                    f.write(f'  "normal N" [ {" ".join(N)} ]\n')
                if st:
                    f.write(f'  "float st" [ {" ".join(st)} ]\n')
                f.write(f'  "integer indices" [ {" ".join(idx)} ]\n')
            f.write("AttributeEnd\n\n\n")

    print(f"obj2pbrt: converted {sum(1 for _, fs in shapes if fs)} meshes "
          f"({n_tris} triangles, {n_lights} mesh emitters) -> {out_path}",
          file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="obj2pbrt")
    ap.add_argument("obj")
    ap.add_argument("pbrt")
    args = ap.parse_args(argv)
    return obj_to_pbrt(args.obj, args.pbrt)


if __name__ == "__main__":
    sys.exit(main())
