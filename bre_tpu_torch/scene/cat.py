"""Scene pretty-printer for the CLI's --cat / --toply flags (counterpart of
``bre_tpu/scene/cat.py``).

pbrt's src/main/pbrt.cpp:47-70 (--cat "print a
reformatted version of the input file(s) to standard output", --toply
"...and convert large triangle meshes to PLY files"); the printing itself
is threaded through the API layer via PbrtOptions.cat/toPly (api.cpp).

Here the reformatter is a token-stream walker: Include directives are
expanded (like the renderer's parser), one directive per line, each
parameter declaration on its own indented line.  With ``toply_dir`` set,
``Shape "trianglemesh"`` statements with at least ``min_tris`` triangles
are written to mesh_NNNNN.ply (io/ply.write_ply) and re-emitted as
``Shape "plymesh"`` — the same transformation pbrt's --toply performs.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from ..io.ply import write_ply
from .parser import _is_number, tokenize

# token starts a parameter declaration: a quoted "<type> <name>" pair
_PARAM_TYPES = (
    "integer", "float", "bool", "string", "point", "point2", "point3",
    "vector", "vector2", "vector3", "normal", "normal3", "rgb", "color",
    "xyz", "spectrum", "blackbody", "texture",
)


def _is_param_decl(tok: str) -> bool:
    if not (tok.startswith('"') and tok.endswith('"') and " " in tok):
        return False
    return tok.strip('"').split()[0] in _PARAM_TYPES


def _fmt_value(tok: str) -> str:
    if _is_number(tok):
        f = float(tok)
        i = int(f)
        return str(i) if f == i else repr(f)
    return tok


class _MeshWriter:
    def __init__(self, out_dir: Path, min_tris: int):
        self.out_dir = Path(out_dir)
        self.min_tris = min_tris
        self.count = 0

    def maybe_convert(self, params: dict) -> Optional[str]:
        """If the trianglemesh is big enough, write a .ply and return its
        filename; otherwise None."""
        idx = np.asarray(params.get("indices", []), np.int64).reshape(-1, 3)
        pts = np.asarray(params.get("P", []), np.float32).reshape(-1, 3)
        if idx.shape[0] < self.min_tris:
            return None
        self.count += 1
        name = f"mesh_{self.count:05d}.ply"
        write_ply(self.out_dir / name, pts, idx)
        return name


def cat_scene(text: str, include_dir: Path = Path("."),
              toply_dir: Optional[Path] = None, min_tris: int = 500) -> str:
    """Reformat a .pbrt scene (expand Includes, one directive per line,
    params on indented lines).  Returns the formatted text."""
    toks: List[str] = tokenize(text)
    mesh = _MeshWriter(toply_dir, min_tris) if toply_dir is not None else None

    out: List[str] = []
    indent = 0
    i = 0
    n = len(toks)

    def pad() -> str:
        return "    " * indent

    while i < n:
        tok = toks[i]
        if tok == "Include":
            inc = toks[i + 1].strip('"')
            sub = tokenize((Path(include_dir) / inc).read_text())
            toks[i : i + 2] = sub
            n = len(toks)
            continue
        if tok in ("AttributeEnd", "TransformEnd", "ObjectEnd", "WorldEnd"):
            indent = max(0, indent - 1)

        # gather this directive's operands: everything up to the next
        # directive keyword
        i += 1
        head_vals: List[str] = []   # positional values (names, numbers)
        params: List[List[str]] = []  # parameter decls, each a token list
        while i < n:
            t = toks[i]
            if t == "Include":
                inc = toks[i + 1].strip('"')
                sub = tokenize((Path(include_dir) / inc).read_text())
                toks[i : i + 2] = sub
                n = len(toks)
                continue
            if _is_param_decl(t):
                group = [t]
                i += 1
                if i < n and toks[i] == "[":
                    while i < n:
                        group.append(toks[i])
                        if toks[i] == "]":
                            i += 1
                            break
                        i += 1
                else:
                    group.append(toks[i])
                    i += 1
                params.append(group)
                continue
            if t.startswith('"') or _is_number(t) or t in ("[", "]"):
                head_vals.append(t)
                i += 1
                continue
            break  # next directive

        # --toply: rewrite big trianglemeshes as plymesh statements
        if (mesh is not None and tok == "Shape"
                and head_vals[:1] == ['"trianglemesh"']):
            pdict: dict = {}
            for group in params:
                name = group[0].strip('"').split(None, 1)[1]
                vals = [g for g in group[1:] if g not in ("[", "]")]
                pdict[name] = [float(v) for v in vals] if vals and _is_number(
                    vals[0]) else vals
            fname = mesh.maybe_convert(pdict)
            if fname is not None:
                out.append(f'{pad()}Shape "plymesh"')
                out.append(f'{pad()}    "string filename" [ "{fname}" ]')
                continue

        line = pad() + tok
        if head_vals:
            line += " " + " ".join(_fmt_value(v) for v in head_vals)
        out.append(line)
        for group in params:
            decl = group[0]
            vals = [g for g in group[1:] if g not in ("[", "]")]
            body = " ".join(_fmt_value(v) for v in vals)
            out.append(f"{pad()}    {decl} [ {body} ]")

        if tok in ("AttributeBegin", "TransformBegin", "ObjectBegin",
                   "WorldBegin"):
            indent += 1

    return "\n".join(out) + "\n"
