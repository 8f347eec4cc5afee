"""Bidirectional path tracing (counterpart of
``bre_tpu/integrators/bdpt.py``; pbrt bdpt.{h,cpp}: GenerateCameraSubpath,
GenerateLightSubpath, RandomWalk, ConnectBDPT, MISWeight).

Subpaths are fixed-length lists of batched vertex records, one (R,)-shaped
``VertexB`` per slot, built by an unrolled Python loop (maxdepth is small).
Every (s,t) strategy runs for the whole batch with masked arithmetic.
Media vertices are first-class; camera importance exists for the
perspective camera, the port's only one.

Where the reference runs one pass of R = W*H lanes per sample, several
samples' passes walk together here (``SAMPLE_LANES``), each lane on its own
stream ``RNG(sample * R + pixel + 0xB0D7)``, which changes no lane's
arithmetic.  The t = 1 strategies splat onto the film through
``core.math.ordered_index_sum``, a sorted segment sum in lane order, in
place of the reference's ``.at[].add``: two runs on a card give the same
bits.

A reference quirk kept on purpose: ``_segment_interaction`` hands
``sample_medium`` the stream state read before its two uniforms were
drawn, and stores the state it returns, so in PCG mode the draws of each
sub-segment, and then the phase and BSDF draws that follow, repeat the
same uniforms (bdpt.py:255-256).  The port does the same, so the walks
match draw for draw.

The port carries point lights and diffuse area lights only, and matte as
its only material: point lights are its only delta lights, no light is
delta in direction, every surface with a material is connectible, and no
light is infinite (an escaped camera ray still ends in a light vertex, as
in the reference, and finds no radiance there).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.math import (PI, absdot, dot, normalize,
                         offset_ray_origin, ordered_index_sum)
from ..core.rng import pcg32_init, pcg32_next_f32
from ..core.samplers import camera_jitter
from ..core.sampling import sample_discrete
from ..lights import (area_light_emitted, escaped_radiance, light_choice_pmf,
                      light_power_distribution, pdf_le, sample_le, sample_li)
from ..materials import MODE_IMPORTANCE, MODE_RADIANCE, eval_bsdf, sample_bsdf
from ..media import gather_medium, hg_p, hg_sample_p, sample_medium
from ..scene.camera import (Camera, camera_position, generate_rays, pdf_we,
                            pixel_centers, sample_wi)
from ..scene.intersect import intersect, intersect_p
from ..scene.scene import (LIGHT_POINT, MAT_GLASS, MAT_MIRROR, Scene,
                           check_slice, world_radius)
from .common import default_tr_crossings, segment_transmittance_walk

# vertex types (bdpt.h VertexType)
VT_CAMERA = 0
VT_LIGHT = 1
VT_SURFACE = 2
VT_MEDIUM = 3

_N_BOUNDARY_SKIPS = 3  # null-material crossings allowed per segment
_U32 = 0xFFFFFFFF
# lanes per batch of sample passes, as in volpath
SAMPLE_LANES = 1 << 18


class PathSampler:
    """Uniform-draw source for path construction (bdpt.py:89-123): per-lane
    PCG32 streams (``PathSampler(rng)``), or successive columns of an (R, D)
    primary-sample matrix (``PathSampler(rng, u)``, MLT), ``rng`` then
    backing only the grid tracking.  The cursor is one Python int: every
    lane consumes every draw."""

    def __init__(self, rng, u: Optional[torch.Tensor] = None):
        self.rng = rng
        # column-major, so that each draw is a contiguous (R,) row
        self.u_cols = None if u is None else u.T.contiguous()
        self.cursor = 0

    def next1(self) -> torch.Tensor:
        if self.u_cols is not None:
            x = self.u_cols[self.cursor]
            self.cursor += 1
            return x
        self.rng, x = pcg32_next_f32(self.rng)
        return x

    def next2(self) -> torch.Tensor:
        a = self.next1()
        b = self.next1()
        return torch.stack([a, b], -1)


@dataclasses.dataclass(frozen=True)
class BDPTConfig:
    """The reference's BDPTConfig, field for field (bdpt.py:126-134)."""

    maxdepth: int = 5
    spp: int = 16
    sampler: str = "random"
    # connection-segment transmittance across null-material boundaries;
    # None = resolve from the scene (common.default_tr_crossings)
    tr_crossings: Optional[int] = None


class VertexB(NamedTuple):
    """One batched path vertex (all fields (R,) or (R,3))."""

    valid: torch.Tensor  # bool: slot occupied
    vtype: torch.Tensor  # int64 VT_*
    p: torch.Tensor
    n: torch.Tensor  # geometric normal (zero off-surface): offsets, densities
    ns: torch.Tensor  # shading normal: BSDF frames, connection cosines
    beta: torch.Tensor  # throughput up to and including this vertex
    pdf_fwd: torch.Tensor  # area-measure pdf of sampling this vertex forward
    pdf_rev: torch.Tensor  # the same from the far end
    delta: torch.Tensor  # bool: specular scattering vertex
    connectible: torch.Tensor  # bool: Vertex::IsConnectible
    mat: torch.Tensor  # int64 material (-1 none)
    med: torch.Tensor  # int64 medium the incoming ray travelled through
    area_light: torch.Tensor  # int64 area light of the surface (-1 none)
    light_idx: torch.Tensor  # int64 light (light vertices; -2 escaped ray)
    wo: torch.Tensor  # unit direction toward the previous vertex


def _empty_vertex(R: int, dev) -> VertexB:
    z3 = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    zi = torch.full((R,), -1, dtype=torch.int64, device=dev)
    zf = torch.zeros((R,), dtype=torch.float32, device=dev)
    zb = torch.zeros((R,), dtype=torch.bool, device=dev)
    return VertexB(valid=zb, vtype=torch.zeros_like(zi), p=z3, n=z3, ns=z3,
                   beta=z3, pdf_fwd=zf, pdf_rev=zf, delta=zb, connectible=zb,
                   mat=zi, med=zi, area_light=zi, light_idx=zi, wo=z3)


def _remap0(x: torch.Tensor) -> torch.Tensor:
    """MISWeight's remap0 (bdpt.cpp:238): 0 pdfs count as 1 in ratios."""
    return torch.where(x != 0.0, x, 1.0)


def _on_surf(v: VertexB) -> torch.Tensor:
    return v.n.abs().sum(-1) > 0.0


def _convert_density(pdf_dir, p_from, v_to_p, v_to_n, to_on_surface,
                     to_infinite):
    """Vertex::ConvertDensity (bdpt.h:190-201): solid angle -> area at the
    next vertex; escaped-ray vertices keep solid-angle densities."""
    w = v_to_p - p_from
    inv_d2 = 1.0 / torch.clamp_min(dot(w, w), 1e-20)
    cos_f = torch.where(to_on_surface,
                        dot(v_to_n, w).abs() * torch.sqrt(inv_d2), 1.0)
    return torch.where(to_infinite, pdf_dir, pdf_dir * inv_d2 * cos_f)


def _is_delta_light(scene: Scene, light_idx):
    """IsDeltaLight (light.h:88-92): point lights, the port's only delta
    lights."""
    if scene.n_lights == 0:
        return torch.zeros(light_idx.shape, dtype=torch.bool,
                           device=light_idx.device)
    lt = scene.lights.ltype[torch.clamp(light_idx, 0, scene.n_lights - 1)]
    return (light_idx >= 0) & (lt == LIGHT_POINT)


def _surface_connectible(scene: Scene, mat_idx):
    """IsConnectible for surfaces (bdpt.h:246-252): a non-delta lobe, which
    every ported material but mirror and glass has."""
    nm = scene.materials.mtype.shape[0]
    if nm == 0:
        return torch.zeros(mat_idx.shape, dtype=torch.bool,
                           device=mat_idx.device)
    mt = scene.materials.mtype[torch.clamp(mat_idx, 0, nm - 1)]
    return (mat_idx >= 0) & (mt != MAT_MIRROR) & (mt != MAT_GLASS)


# --------------------------------------------------------------------------
# Random walk (bdpt.cpp RandomWalk)
# --------------------------------------------------------------------------

def _segment_interaction(scene: Scene, o, d, medium, active,
                         sp: PathSampler):
    """March one path segment across up to _N_BOUNDARY_SKIPS null-material
    interfaces, sampling the medium on each sub-segment (bdpt.py:227-289).
    kind 0 = miss, 1 = medium scatter, 2 = surface."""
    R, dev = o.shape[0], o.device
    cur_o, cur_med = o, medium
    pending = active
    weight = torch.ones((R, 3), dtype=torch.float32, device=dev)
    kind = torch.zeros((R,), dtype=torch.int64, device=dev)
    out_p = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    out_n, out_ns = out_p, out_p
    none = torch.full((R,), -1, dtype=torch.int64, device=dev)
    out_mat = out_al = out_med = out_med_in = out_med_out = none

    for _ in range(_N_BOUNDARY_SKIPS + 1):
        h = intersect(scene, cur_o, d)
        t_lim = torch.where(h.valid, h.t, 1e6)
        h_p = cur_o + torch.clamp_max(h.t, 1e6)[:, None] * d
        # the reference's draw reuse (module docstring): sp.rng is read
        # before sp.next2() draws, and the returned state is stored
        sp.rng, ms, _ = sample_medium(scene.media, cur_med, cur_o, d, t_lim,
                                      sp.rng, u12=sp.next2(),
                                      early_exit=False)
        scat = pending & ms.sampled
        weight = torch.where(pending[:, None], weight * ms.weight, weight)

        p_med = cur_o + ms.t[:, None] * d
        kind = torch.where(scat, 1, kind)
        out_p = torch.where(scat[:, None], p_med, out_p)
        out_med = torch.where(scat, cur_med, out_med)

        surf = pending & ~ms.sampled & h.valid
        is_boundary = surf & (h.material < 0)
        real_surf = surf & ~is_boundary
        kind = torch.where(real_surf, 2, kind)
        out_p = torch.where(real_surf[:, None], h_p, out_p)
        out_n = torch.where(real_surf[:, None], h.n, out_n)
        out_ns = torch.where(real_surf[:, None], h.ns, out_ns)
        out_mat = torch.where(real_surf, h.material, out_mat)
        out_al = torch.where(real_surf, h.area_light, out_al)
        out_med = torch.where(real_surf, cur_med, out_med)
        out_med_in = torch.where(real_surf, h.medium_inside, out_med_in)
        out_med_out = torch.where(real_surf, h.medium_outside, out_med_out)

        # null interface: hop across, switch medium, keep marching
        entering = dot(d, h.n) < 0.0
        med_next = torch.where(entering, h.medium_inside, h.medium_outside)
        cur_med = torch.where(is_boundary, med_next, cur_med)
        cur_o = torch.where(is_boundary[:, None],
                            offset_ray_origin(h_p, h.n, d), cur_o)
        pending = is_boundary

    return dict(kind=kind, weight=weight, p=out_p, n=out_n, ns=out_ns,
                mat=out_mat, area_light=out_al, med=out_med,
                med_in=out_med_in, med_out=out_med_out)


def _random_walk(scene: Scene, sp: PathSampler, o, d, beta, pdf_dir, medium,
                 active, n_vertices: int, mode: int, prev0: VertexB):
    """bdpt.cpp RandomWalk (bdpt.py:292-415): extend a subpath by up to
    n_vertices vertices; prev0 is the endpoint whose pdf_rev the walk fills
    in.  Returns ([VertexB] * n_vertices, updated prev0)."""
    R, dev = o.shape[0], o.device
    verts = []
    prev = prev0
    prev_p = prev0.p
    prev_on_surf = (prev0.vtype == VT_SURFACE) | _on_surf(prev0)
    pdf_fwd_dir = pdf_dir
    alive = active & (pdf_dir > 0.0)
    no = torch.zeros((R,), dtype=torch.bool, device=dev)
    w_r = world_radius(scene)

    for _slot in range(n_vertices):
        it = _segment_interaction(scene, o, d, medium, alive, sp)
        kind = it["kind"]
        beta = beta * it["weight"]
        is_med = alive & (kind == 1)
        is_surf = alive & (kind == 2)
        is_miss = alive & (kind == 0)

        # an escaped ray ends in a light vertex "at infinity" (radiance
        # transport only)
        p_inf = o + d * (2.0 * torch.clamp_min(w_r, 1.0))
        make_inf = is_miss & (mode == MODE_RADIANCE)

        hit = is_med | is_surf
        p_new = torch.where(hit[:, None], it["p"], p_inf)
        pdf_fwd_area = _convert_density(pdf_fwd_dir, prev_p, p_new, it["n"],
                                        is_surf, make_inf)
        vtype = torch.where(is_med, VT_MEDIUM,
                            torch.where(is_surf, VT_SURFACE, VT_LIGHT))
        valid = hit | make_inf
        wo = -d

        # the continuation: HG phase in a medium (pdf symmetric in wo, wi),
        # the BSDF in the shading frame at a surface (bdpt.cpp:196-199)
        _, _, g_here, _, _ = gather_medium(scene.media, it["med"])
        wi_phase, pdf_phase = hg_sample_p(wo, g_here, sp.next2())
        bs = sample_bsdf(scene.materials, it["mat"], it["ns"], wo,
                         sp.next2(), mode=mode)
        _, pdf_rev_surf = eval_bsdf(scene.materials, it["mat"], it["ns"],
                                    bs.wi, wo)
        pdf_rev_dir = torch.where(is_med, pdf_phase,
                                  torch.where(bs.specular, 0.0, pdf_rev_surf))
        pdf_fwd_next = torch.where(is_med, pdf_phase,
                                   torch.where(bs.specular, 0.0, bs.pdf))

        delta = is_surf & bs.specular
        connectible = torch.where(is_med, True,
                                  _surface_connectible(scene, it["mat"]))
        vert = VertexB(
            valid=valid, vtype=vtype, p=p_new,
            n=torch.where(is_surf[:, None], it["n"], 0.0),
            ns=torch.where(is_surf[:, None], it["ns"], 0.0),
            beta=torch.where(valid[:, None], beta, 0.0),
            pdf_fwd=torch.where(valid, pdf_fwd_area, 0.0),
            pdf_rev=torch.zeros((R,), dtype=torch.float32, device=dev),
            delta=delta, connectible=valid & connectible,
            mat=it["mat"], med=it["med"], area_light=it["area_light"],
            light_idx=torch.where(make_inf, -2, -1),
            wo=wo,
        )

        # the previous vertex's reverse pdf (RandomWalk's tail:
        # prev.pdfRev = ConvertDensity(pdfRev, prev))
        prev_rev = _convert_density(pdf_rev_dir, p_new, prev_p, prev.n,
                                    prev_on_surf, no)
        prev = prev._replace(pdf_rev=torch.where(hit, prev_rev, prev.pdf_rev))
        if verts:
            verts[-1] = prev
        else:
            prev0 = prev
        verts.append(vert)
        prev = vert
        prev_p = p_new
        prev_on_surf = is_surf

        o = torch.where(is_med[:, None], p_new,
                        offset_ray_origin(p_new, it["n"], bs.wi))
        d = torch.where(is_med[:, None], wi_phase, bs.wi)
        # the medium a surface bounce leaves into: the side of the
        # geometric normal the continuation takes
        medium = torch.where(
            is_surf & (dot(bs.wi, it["n"]) > 0.0), it["med_out"],
            torch.where(is_surf, it["med_in"], it["med"]))
        # beta *= f |wi.ns| / pdf (bdpt.cpp:199), then CorrectShadingNormal
        # in importance transport (bdpt.cpp:206, factor at :55-66)
        took = is_surf & bs.valid & (bs.pdf > 0.0)
        beta_scale = torch.where(
            took, absdot(bs.wi, it["ns"]) / torch.where(bs.pdf > 0.0, bs.pdf,
                                                        1.0), 1.0)
        if mode == MODE_IMPORTANCE:
            csn_num = absdot(wo, it["ns"]) * absdot(bs.wi, it["n"])
            csn_den = torch.clamp_min(
                absdot(wo, it["n"]) * absdot(bs.wi, it["ns"]), 1e-12)
            beta_scale = beta_scale * torch.where(took, csn_num / csn_den, 1.0)
        beta = torch.where(is_surf[:, None], beta * bs.f * beta_scale[:, None],
                           beta)
        alive = (is_med & (pdf_phase > 0.0)) | took
        alive = alive & (beta.abs().sum(-1) > 0.0)
        pdf_fwd_dir = pdf_fwd_next

    return verts, prev0


def _generate_camera_subpath(scene: Scene, camera: Camera, width, height, o,
                             d, sp: PathSampler, maxdepth: int):
    """GenerateCameraSubpath (bdpt.cpp:~365-385): camera endpoint + walk."""
    R, dev = o.shape[0], o.device
    medium = scene.camera_medium.expand(R)
    cam_v = _empty_vertex(R, dev)._replace(
        valid=torch.ones((R,), dtype=torch.bool, device=dev),
        vtype=torch.full((R,), VT_CAMERA, dtype=torch.int64, device=dev),
        p=camera_position(camera).expand(R, 3),
        beta=torch.ones((R, 3), dtype=torch.float32, device=dev),
        connectible=torch.ones((R,), dtype=torch.bool, device=dev),
        med=medium)
    _, pdf_dir = pdf_we(camera, width, height, d)
    verts, cam_v = _random_walk(
        scene, sp, o, d, torch.ones((R, 3), dtype=torch.float32, device=dev),
        pdf_dir, medium, torch.ones((R,), dtype=torch.bool, device=dev),
        maxdepth + 1, MODE_RADIANCE, cam_v)
    return [cam_v] + verts


def _generate_light_subpath(scene: Scene, sp: PathSampler, R: int,
                            maxdepth: int, pmf):
    """GenerateLightSubpath (bdpt.cpp:~387-418)."""
    light_idx, pdf_choice = sample_discrete(light_power_distribution(scene),
                                            sp.next1())
    ls = sample_le(scene, light_idx, sp.next2(), sp.next2())
    ok = (pdf_choice > 0.0) & (ls.pdf_pos > 0.0) & (ls.pdf_dir > 0.0)
    light_v = _empty_vertex(R, pdf_choice.device)._replace(
        valid=ok,
        vtype=torch.full((R,), VT_LIGHT, dtype=torch.int64,
                         device=pdf_choice.device),
        p=ls.o, n=ls.n_light, ns=ls.n_light, beta=ls.Le,
        pdf_fwd=ls.pdf_pos * pdf_choice, connectible=ok,
        light_idx=light_idx, med=ls.medium)
    # point lights report n_light == d, so cos_l is 1 there
    cos_l = dot(ls.n_light, ls.d).abs()
    denom = pdf_choice * ls.pdf_pos * ls.pdf_dir
    beta = ls.Le * (cos_l / torch.clamp_min(denom, 1e-30))[:, None]
    beta = torch.where(ok[:, None], beta, 0.0)
    o = offset_ray_origin(ls.o, ls.n_light, ls.d)
    verts, light_v = _random_walk(scene, sp, o, ls.d, beta, ls.pdf_dir,
                                  ls.medium, ok, maxdepth, MODE_IMPORTANCE,
                                  light_v)
    return [light_v] + verts


# --------------------------------------------------------------------------
# Vertex pdf queries used by MISWeight
# --------------------------------------------------------------------------

def _vertex_f(scene: Scene, v: VertexB, to_p, mode: int = MODE_RADIANCE):
    """Vertex::f (bdpt.h:224-238): BSDF or phase toward to_p, with
    CorrectShadingNormal in importance transport."""
    wi = normalize(to_p - v.p)
    f_s, _ = eval_bsdf(scene.materials, v.mat, v.ns, v.wo, wi)
    if mode == MODE_IMPORTANCE:
        csn_num = absdot(v.wo, v.ns) * absdot(wi, v.n)
        csn_den = torch.clamp_min(absdot(v.wo, v.n) * absdot(wi, v.ns), 1e-12)
        f_s = f_s * torch.where(_on_surf(v), csn_num / csn_den, 1.0)[:, None]
    _, _, g_here, _, _ = gather_medium(scene.media, v.med)
    f_m = hg_p(v.wo, wi, g_here)[:, None].expand(-1, 3)
    return torch.where((v.vtype == VT_MEDIUM)[:, None], f_m, f_s)


def _vertex_pdf(scene: Scene, camera: Camera, width, height, v: VertexB,
                prev_p, nxt_p, nxt_n, nxt_on_surf, nxt_inf):
    """Vertex::Pdf(scene, prev, next) (bdpt.h:282-310): the directional
    density of sampling next from v, converted to area at next."""
    wn = normalize(nxt_p - v.p)
    wp = normalize(prev_p - v.p)
    _, pdf_surf = eval_bsdf(scene.materials, v.mat, v.ns, wp, wn)
    _, _, g_here, _, _ = gather_medium(scene.media, v.med)
    pdf_med = hg_p(wp, wn, g_here)
    _, pdf_cam = pdf_we(camera, width, height, wn)
    pdf_dir = torch.where(v.vtype == VT_MEDIUM, pdf_med,
                          torch.where(v.vtype == VT_CAMERA, pdf_cam, pdf_surf))
    pdf_light = _pdf_light(scene, v, nxt_p, nxt_n, nxt_on_surf)
    area = _convert_density(pdf_dir, v.p, nxt_p, nxt_n, nxt_on_surf, nxt_inf)
    return torch.where(v.vtype == VT_LIGHT, pdf_light, area)


def _effective_light_idx(v: VertexB):
    """A vertex's light: light_idx on light vertices (-2 for an escaped
    ray), area_light on emitting surfaces (Vertex::IsLight)."""
    return torch.where(v.light_idx != -1, v.light_idx, v.area_light)


def _pdf_light(scene: Scene, v: VertexB, nxt_p, nxt_n, nxt_on_surf):
    """Vertex::PdfLight (bdpt.h:312-340): the emission direction's density
    at the light, converted to area at next."""
    w = nxt_p - v.p
    d2 = torch.clamp_min(dot(w, w), 1e-20)
    wn = w / torch.sqrt(d2)[:, None]
    eff = _effective_light_idx(v)
    w_r = world_radius(scene)
    pdf_inf = 1.0 / (PI * w_r * w_r)
    _, pdf_dir = pdf_le(scene, torch.clamp_min(eff, 0), v.n, wn)
    pdf = torch.where(eff == -2, pdf_inf, pdf_dir / d2)
    return pdf * torch.where(nxt_on_surf, dot(nxt_n, wn).abs(), 1.0)


def _pdf_light_origin(scene: Scene, v: VertexB, nxt_p, pmf):
    """Vertex::PdfLightOrigin (bdpt.h:342-364).  Point lights take their
    sampled-position density 1 (Sample_Le's, point.cpp), not Pdf_Le's 0;
    an escaped ray's origin density is 0: the port has no infinite light."""
    w = normalize(nxt_p - v.p)
    eff = _effective_light_idx(v)
    li = torch.clamp_min(eff, 0)
    pdf_pos, _ = pdf_le(scene, li, v.n, w)
    if scene.n_lights == 0:
        choice = torch.zeros(v.light_idx.shape, dtype=torch.float32,
                             device=w.device)
    else:
        choice = pmf[torch.clamp(li, 0, scene.n_lights - 1)]
    pdf_pos = torch.where(_is_delta_light(scene, eff), 1.0, pdf_pos)
    return torch.where(eff == -2, 0.0, choice * pdf_pos)


# --------------------------------------------------------------------------
# MIS weight (bdpt.cpp MISWeight :228-330)
# --------------------------------------------------------------------------

def _mis_weight(scene: Scene, camera: Camera, width, height, cam_vs,
                light_vs, s: int, t: int, sampled: Optional[VertexB], pmf):
    """Balance-heuristic weight of strategy (s,t) over the batch."""
    R, dev = cam_vs[0].p.shape[0], cam_vs[0].p.device
    if s + t == 2:
        return torch.ones((R,), dtype=torch.float32, device=dev)

    pt = sampled if (t == 1 and sampled is not None) else cam_vs[t - 1]
    pt_minus = cam_vs[t - 2] if t > 1 else None
    qs = sampled if (s == 1 and sampled is not None) else (
        light_vs[s - 1] if s > 0 else None)
    qs_minus = light_vs[s - 2] if s > 1 else None
    zeros_b = torch.zeros((R,), dtype=torch.bool, device=dev)

    def v_is_inf(v):
        return v.light_idx == -2

    # the junction pdf overrides (the ScopedAssignment block)
    if s > 0:
        prev_p = qs_minus.p if qs_minus is not None else qs.p
        pt_rev = _vertex_pdf(scene, camera, width, height, qs, prev_p, pt.p,
                             pt.n, _on_surf(pt), v_is_inf(pt))
    else:
        pt_rev = _pdf_light_origin(scene, pt, pt_minus.p, pmf)

    pt_minus_rev = None
    if t > 1:
        if s > 0:
            pt_minus_rev = _vertex_pdf(
                scene, camera, width, height, pt, qs.p, pt_minus.p,
                pt_minus.n, _on_surf(pt_minus), v_is_inf(pt_minus))
        else:
            pt_minus_rev = _pdf_light(scene, pt, pt_minus.p, pt_minus.n,
                                      _on_surf(pt_minus))
    qs_rev = None
    if s > 0:
        prev_p = pt_minus.p if pt_minus is not None else pt.p
        qs_rev = _vertex_pdf(scene, camera, width, height, pt, prev_p, qs.p,
                             qs.n, _on_surf(qs), zeros_b)
    qs_minus_rev = None
    if s > 1:
        qs_minus_rev = _vertex_pdf(scene, camera, width, height, qs, pt.p,
                                   qs_minus.p, qs_minus.n,
                                   _on_surf(qs_minus), zeros_b)

    # the camera side's products
    sum_ri = torch.zeros((R,), dtype=torch.float32, device=dev)
    ri = torch.ones((R,), dtype=torch.float32, device=dev)
    for i in range(t - 1, 0, -1):
        v = cam_vs[i]
        rev = v.pdf_rev
        if i == t - 1:
            rev = pt_rev
        elif i == t - 2 and pt_minus_rev is not None:
            rev = pt_minus_rev
        ri = ri * _remap0(rev) / _remap0(v.pdf_fwd)
        d_i = zeros_b if i == t - 1 else v.delta  # pt.delta forced false
        sum_ri = sum_ri + torch.where(~d_i & ~cam_vs[i - 1].delta & v.valid,
                                      ri, 0.0)

    # the light side's
    ri = torch.ones((R,), dtype=torch.float32, device=dev)
    for i in range(s - 1, -1, -1):
        v = sampled if (i == 0 and s == 1 and sampled is not None) \
            else light_vs[i]
        rev = v.pdf_rev
        if i == s - 1 and qs_rev is not None:
            rev = qs_rev
        elif i == s - 2 and qs_minus_rev is not None:
            rev = qs_minus_rev
        ri = ri * _remap0(rev) / _remap0(v.pdf_fwd)
        d_i = zeros_b if i == s - 1 else v.delta  # qs.delta forced false
        if i > 0:
            d_prev = light_vs[i - 1].delta
        else:
            d_prev = _is_delta_light(scene, _effective_light_idx(v))
        sum_ri = sum_ri + torch.where(~d_i & ~d_prev & v.valid, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


# --------------------------------------------------------------------------
# Connections (bdpt.cpp ConnectBDPT)
# --------------------------------------------------------------------------

def _shadow_origin(v: VertexB, wi):
    return torch.where(_on_surf(v)[:, None], offset_ray_origin(v.p, v.n, wi),
                       v.p)


def _g_term(scene: Scene, va: VertexB, vb: VertexB, tr_crossings: int = 0):
    """G(scene, sampler, v0, v1) (bdpt.cpp:~200-226) with visibility and
    Tr; cosines on the shading normals (bdpt.cpp:222-223), the ray offset
    on the geometric one."""
    w = vb.p - va.p
    d2 = torch.clamp_min(dot(w, w), 1e-20)
    dist = torch.sqrt(d2)
    wn = w / dist[:, None]
    g = 1.0 / d2
    g = g * torch.where(_on_surf(va), dot(va.ns, wn).abs(), 1.0)
    g = g * torch.where(_on_surf(vb), dot(vb.ns, wn).abs(), 1.0)
    o = _shadow_origin(va, wn)
    t_shadow = dist * (1.0 - 1e-3)
    occluded = intersect_p(scene, o, wn, t_shadow)
    tr = segment_transmittance_walk(scene, va.med, o, wn, t_shadow,
                                    tr_crossings)
    return torch.where(occluded[:, None], 0.0, g[:, None] * tr)


def _vertex_le(scene: Scene, v: VertexB, toward_p):
    """Vertex::Le (bdpt.h:210-222): emitted radiance toward toward_p."""
    w = normalize(toward_p - v.p)
    L_area = area_light_emitted(scene, v.area_light, v.n, w)
    return torch.where((v.light_idx == -2)[:, None],
                       escaped_radiance(scene, -w), L_area)


def connect_bdpt(scene: Scene, camera: Camera, width, height, cam_vs,
                 light_vs, s: int, t: int, sp: PathSampler, pmf,
                 tr_crossings: int = 0):
    """One (s,t) strategy for the batch (bdpt.py:691-782).  Returns (L,
    splat_raster, splat_L, splat_ok); the splat_* matter when t == 1."""
    R, dev = cam_vs[0].p.shape[0], cam_vs[0].p.device
    L = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    splat_raster = torch.zeros((R, 2), dtype=torch.float32, device=dev)
    splat_ok = torch.zeros((R,), dtype=torch.bool, device=dev)
    sampled = None

    if s == 0:
        # the camera path alone: pt must be emissive
        pt = cam_vs[t - 1]
        is_light = pt.valid & ((pt.area_light >= 0) | (pt.light_idx == -2))
        L = pt.beta * _vertex_le(scene, pt, cam_vs[t - 2].p)
        L = torch.where(is_light[:, None], L, 0.0)
    elif t == 1:
        # light tracing: connect qs to the camera and splat
        qs = light_vs[s - 1]
        wi, pdf, We, p_raster, dist = sample_wi(camera, width, height, qs.p)
        ok = qs.valid & qs.connectible & (pdf > 0.0)
        f = _vertex_f(scene, qs, qs.p + wi, MODE_IMPORTANCE)
        cos_q = torch.where(_on_surf(qs), dot(qs.ns, wi).abs(), 1.0)
        o = _shadow_origin(qs, wi)
        t_shadow = dist * (1.0 - 1e-3)
        occluded = intersect_p(scene, o, wi, t_shadow)
        tr = segment_transmittance_walk(scene, qs.med, o, wi, t_shadow,
                                        tr_crossings)
        L = qs.beta * f * We * (cos_q / torch.clamp_min(pdf, 1e-30))[:, None] \
            * tr
        ok = ok & ~occluded
        L = torch.where(ok[:, None], L, 0.0)
        # the sampled camera vertex, for MIS
        sampled = _empty_vertex(R, dev)._replace(
            valid=ok,
            vtype=torch.full((R,), VT_CAMERA, dtype=torch.int64, device=dev),
            p=camera_position(camera).expand(R, 3),
            beta=We / torch.clamp_min(pdf, 1e-30)[:, None],
            connectible=torch.ones((R,), dtype=torch.bool, device=dev),
            med=qs.med)
        splat_raster = p_raster
        splat_ok = ok
    elif s == 1:
        # next-event estimation from pt: a light from the power distribution
        pt = cam_vs[t - 1]
        light_idx, pdf_choice = sample_discrete(
            light_power_distribution(scene), sp.next1())
        ls = sample_li(scene, light_idx, pt.p, sp.next2())
        ok = pt.valid & pt.connectible & (ls.pdf > 0.0) & (pdf_choice > 0.0)
        f = _vertex_f(scene, pt, pt.p + ls.wi)
        cos_p = torch.where(_on_surf(pt), dot(pt.ns, ls.wi).abs(), 1.0)
        o = _shadow_origin(pt, ls.wi)
        t_shadow = ls.dist * (1.0 - 1e-3)
        occluded = intersect_p(scene, o, ls.wi, t_shadow)
        tr = segment_transmittance_walk(scene, pt.med, o, ls.wi, t_shadow,
                                        tr_crossings)
        denom = torch.clamp_min(ls.pdf * pdf_choice, 1e-30)
        L = pt.beta * f * ls.Li * (cos_p / denom)[:, None] * tr
        ok = ok & ~occluded
        L = torch.where(ok[:, None], L, 0.0)
        # the sampled light vertex, for MIS (CreateLight, PdfLightOrigin)
        lv = _empty_vertex(R, dev)._replace(
            valid=ok,
            vtype=torch.full((R,), VT_LIGHT, dtype=torch.int64, device=dev),
            p=ls.p_light, n=ls.n_light, ns=ls.n_light,
            beta=ls.Li / torch.clamp_min(denom, 1e-30)[:, None],
            light_idx=light_idx, connectible=ok, med=pt.med)
        sampled = lv._replace(pdf_fwd=_pdf_light_origin(scene, lv, pt.p, pmf))
    else:
        qs, pt = light_vs[s - 1], cam_vs[t - 1]
        ok = qs.valid & pt.valid & qs.connectible & pt.connectible
        f_q = _vertex_f(scene, qs, pt.p, MODE_IMPORTANCE)
        f_p = _vertex_f(scene, pt, qs.p)
        G = _g_term(scene, pt, qs, tr_crossings)
        L = qs.beta * f_q * f_p * pt.beta * G
        L = torch.where(ok[:, None], L, 0.0)

    nonzero = L.abs().sum(-1) > 0.0
    w = torch.where(nonzero, _mis_weight(scene, camera, width, height, cam_vs,
                                         light_vs, s, t, sampled, pmf), 0.0)
    L = L * w[:, None]
    return L, splat_raster, L, splat_ok


def strategies(maxdepth: int):
    """The (s,t) pairs one pass evaluates, in the reference's order
    (bdpt.py:819-825): t from 1 to maxdepth + 2, s from 0 to maxdepth + 1,
    depth s + t - 2 in [0, maxdepth], without (1,1) and (0,1)."""
    out = []
    for t in range(1, maxdepth + 3):
        for s in range(0, maxdepth + 2):
            depth = t + s - 2
            if depth < 0 or depth > maxdepth or (t == 1 and s < 2):
                continue
            out.append((s, t))
    return out


def raster_pixel(p_raster, width: int, height: int):
    """The film pixel a raster position splats to: truncated to int and
    clipped, as the reference's ``astype(int32)`` and ``clip``."""
    px = torch.clamp(p_raster[:, 0].to(torch.int64), 0, width - 1)
    py = torch.clamp(p_raster[:, 1].to(torch.int64), 0, height - 1)
    return py * width + px


def subpaths(scene: Scene, camera: Camera, width: int, height: int,
             lane_pix, lane_samp, cfg: BDPTConfig, pmf):
    """The camera and light subpaths of a batch of sample passes: lane i
    renders pixel lane_pix[i] for sample lane_samp[i] on the stream
    ``RNG(sample * R + pixel + 0xB0D7)`` (bdpt.py:805-813).  Returns
    (cam_vs, light_vs, the PathSampler they drew from)."""
    R = width * height
    rng = pcg32_init((lane_samp * R + lane_pix + 0xB0D7) & _U32)
    rng, j2 = camera_jitter(cfg.sampler, lane_pix, lane_samp, cfg.spp, rng)
    pix = pixel_centers(width, height, lane_pix.device)[lane_pix]
    o, d = generate_rays(camera, pix + j2 - 0.5)
    smp = PathSampler(rng)
    cam_vs = _generate_camera_subpath(scene, camera, width, height, o, d, smp,
                                      cfg.maxdepth)
    light_vs = _generate_light_subpath(scene, smp, lane_pix.shape[0],
                                       cfg.maxdepth, pmf)
    return cam_vs, light_vs, smp


def bdpt_pass(scene: Scene, camera: Camera, width: int, height: int,
              lane_pix, lane_samp, cfg: BDPTConfig, pmf):
    """One batch of sample passes (the reference's ``one_pass``, for
    several samples at once; lanes as in ``subpaths``).  Returns (L (n, 3)
    of the t > 1 strategies, the t = 1 splats as (n_samples_in_batch * W *
    H, 3) per-sample films)."""
    R = width * height
    dev = lane_pix.device
    cam_vs, light_vs, smp = subpaths(scene, camera, width, height, lane_pix,
                                     lane_samp, cfg, pmf)
    n = lane_pix.shape[0]
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    first = lane_samp[0]
    keys, vals = [], []
    for s, t in strategies(cfg.maxdepth):
        Lst, p_raster, Lsplat, sok = connect_bdpt(
            scene, camera, width, height, cam_vs, light_vs, s, t, smp, pmf,
            tr_crossings=cfg.tr_crossings or 0)
        if t == 1:
            keys.append((lane_samp - first) * R
                        + raster_pixel(p_raster, width, height))
            vals.append(torch.where(sok[:, None], Lsplat, 0.0))
        else:
            L = L + Lst
    n_films = n // R
    if keys:
        # strategies in the reference's order, lanes in order within each
        splat = ordered_index_sum(torch.cat(keys), torch.cat(vals),
                                  n_films * R)
    else:
        splat = torch.zeros((n_films * R, 3), dtype=torch.float32, device=dev)
    return L, splat


def render_bdpt(scene: Scene, camera: Camera, width: int, height: int,
                cfg: BDPTConfig = BDPTConfig()) -> torch.Tensor:
    """Full BDPT render (BDPTIntegrator::Render, bdpt.cpp:~470-560;
    bdpt.py:789-845): up to ``SAMPLE_LANES`` lanes (whole samples of the
    film) per batch, the samples added to the film in sample order, as the
    reference's passes are.  Returns the (H, W, 3) image on the scene's
    device."""
    check_slice(scene)
    if cfg.tr_crossings is None:
        cfg = dataclasses.replace(cfg, tr_crossings=default_tr_crossings(scene))
    dev = scene.device
    R = width * height
    pmf = light_choice_pmf(scene)
    pix_idx = torch.arange(R, dtype=torch.int64, device=dev)
    per_batch = max(1, min(cfg.spp, SAMPLE_LANES // R))
    acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    splat = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    for s0 in range(0, cfg.spp, per_batch):
        n = min(per_batch, cfg.spp - s0)
        lane_samp = torch.arange(s0, s0 + n, dtype=torch.int64,
                                 device=dev).repeat_interleave(R)
        L, sp = bdpt_pass(scene, camera, width, height, pix_idx.repeat(n),
                          lane_samp, cfg, pmf)
        L, sp = L.reshape(n, R, 3), sp.reshape(n, R, 3)
        for k in range(n):
            acc = acc + L[k]
            splat = splat + sp[k]
    return (acc.reshape(height, width, 3) / cfg.spp
            + splat.reshape(height, width, 3) / cfg.spp)
