"""Scene data model: typed SoA pytrees.

This is the data-parallel re-expression of the reference's data contracts
(SURVEY Appendix B): `SysParamter`/`MaterialParams`/`textureParam`/
`LightDefinition`/`HitGroupData` (RestOfLife/shaders/sysparameter.h,
lib/raydata.cuh) become flat device arrays closed over by the jitted render
function.  There is no SBT and no instance table: every primitive row carries
its own typed parameters, material id and transform (replacing the
instance-id-doubles-as-material-index quirk, closehit.cu:50,63 — SURVEY §7.4
quirk 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

# --- Primitive types (prim_type values) ------------------------------------
PRIM_SPHERE = 0          # params: cx cy cz r
PRIM_RECT = 1            # params: a0 a1 b0 b1 k axis flip
PRIM_MOVING_SPHERE = 2   # params: cx cy cz r cx1 cy1 cz1 t0 t1
PRIM_VOLUME_SPHERE = 3   # params: cx cy cz r density
PRIM_VOLUME_BOX = 4      # params: minx miny minz maxx maxy maxz density
PRIM_BOX = 5             # params: minx miny minz maxx maxy maxz
NUM_PRIM_PARAMS = 9

AXIS_X = 0
AXIS_Y = 1
AXIS_Z = 2

# --- Material types (mat_type values) ---------------------------------------
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4
MAT_NORMAL = 5

# --- Texture types (tex_type values) ----------------------------------------
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_IMAGE = 3
TEX_NULL = 4

IDENTITY_3X4 = np.array(
    [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], dtype=np.float32
)


def _register(cls):
    """Register a dataclass as a jax pytree (all fields are leaves)."""
    fields = [f.name for f in dataclasses.fields(cls)]

    def flatten(obj):
        return tuple(getattr(obj, n) for n in fields), None

    def unflatten(_, leaves):
        return cls(*leaves)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@_register
@dataclasses.dataclass
class Primitives:
    """Unified primitive SoA.  [P] rows; transforms default to identity.

    Replaces per-shape GAS builds + the instance table
    (geometry/io*.h, ioGeometryInstance.h): each row = one primitive with its
    object->world / world->object 3x4 transforms pre-inverted on host.
    """

    prim_type: Any      # int32 [P]
    params: Any         # float32 [P, NUM_PRIM_PARAMS]
    material_id: Any    # int32 [P]
    o2w: Any            # float32 [P, 3, 4] object -> world
    w2o: Any            # float32 [P, 3, 4] world -> object
    vol_slot: Any       # int32 [P]; >=0 for volume prims: index of their
                        # per-bounce free-flight uniform column; -1 otherwise
    # --- flattened per-prim shading record -------------------------------
    # The material/texture tables denormalized onto primitives, so the hot
    # path resolves the winning prim's shading inputs without indirect
    # per-ray gathers through [M]/[T] tables (one 1-D gather per column from
    # the winning prim instead of two dependent ones).  `tex_idx`/`odd_idx`/`even_idx`
    # stay INDICES into Textures.color so texture-color gradients and
    # apply_params updates flow through (diff.py).
    mat_type_p: Any     # int32 [P]   MAT_*
    tex_type_p: Any     # int32 [P]   TEX_* of the albedo texture
    fuzz_p: Any         # float32 [P] metal fuzz
    eta_p: Any          # float32 [P] dielectric eta
    scale_p: Any        # float32 [P] noise scale
    image_id_p: Any     # int32 [P]   image index (0 if none)
    tex_idx: Any        # int32 [P]   row in Textures.color
    odd_idx: Any        # int32 [P]   checker odd child row (0 if none)
    even_idx: Any       # int32 [P]   checker even child row
    # Row of Lights this primitive realizes, or -1.  Matched geometrically at
    # BUILD time (builder._match_lights_to_prims), so the integrator's
    # BSDF-side MIS weight identifies the hit light exactly by prim index —
    # no runtime plane/containment tolerances.  Emissive prims not registered
    # as lights stay -1 (NEE can't sample them -> pdf 0 -> full BSDF weight).
    light_row_p: Any    # int32 [P]

    @property
    def count(self) -> int:
        return self.prim_type.shape[0]


@_register
@dataclasses.dataclass
class Materials:
    """Material SoA (one row per material).

    Re-expresses MaterialParams (sysparameter.h:5-14): the callable indices
    become a small integer `mat_type` consumed by masked lockstep shading.
    `albedo_tex` indexes the Textures table.  `fuzz` (metal, clamped <= 1 per
    ioMetalMaterial.h:34-38) and `eta` (dielectric) are dense columns.
    """

    mat_type: Any       # int32 [M]
    albedo_tex: Any     # int32 [M]
    fuzz: Any           # float32 [M]
    eta: Any            # float32 [M]

    @property
    def count(self) -> int:
        return self.mat_type.shape[0]


@_register
@dataclasses.dataclass
class Textures:
    """Texture table + shared lookup tables.

    constant/checker/noise/image/null (texture/*.cu).  Checker children are
    restricted to non-checker textures (one level of nesting — every reference
    scene satisfies this; checkeredTexture.cu recurses via optixDirectCall).
    """

    tex_type: Any       # int32 [T]
    color: Any          # float32 [T, 3]   constant color
    odd: Any            # int32 [T]        checker child ids
    even: Any           # int32 [T]
    scale: Any          # float32 [T]      noise scale
    image_id: Any       # int32 [T]        index into images list (-1 if none)
    # Image atlas, RGB8-packed: one flat uint32 plane (0x00BBGGRR per texel,
    # row-major, images concatenated).  A bilinear fetch is 4 flat 1-D
    # gathers + bit unpack — the multi-dim [n,H,W,3] float gather a
    # cudaTextureObject_t-style layout would need is avoided.  True sizes
    # in image_dims [n_images, 2] = (h, w),
    # start indices in image_offset [n_images].
    images_packed: Any  # uint32 [sum(h*w)]
    # RGB565 pair atlas: texel(x,y) in the low 16 bits, texel(x+1,y)
    # (clamped) in the high 16.  A bilinear fetch needs only TWO flat
    # gathers (rows y0 and y1) instead of four — gathers dominate
    # image-texture cost — and the 5/6/5 quantization is a documented ~1.5%
    # color error (QUIRKS.md).
    images_packed565: Any  # uint32 [sum(h*w)]
    image_offset: Any   # int32 [n_images]
    image_dims: Any     # int32 [n_images, 2]

    @property
    def count(self) -> int:
        return self.tex_type.shape[0]


@_register
@dataclasses.dataclass
class Lights:
    """Parallelogram area lights (raydata.cuh:31-48 LightDefinition)."""

    position: Any       # float32 [L, 3]
    vec_u: Any          # float32 [L, 3]
    vec_v: Any          # float32 [L, 3]
    emission: Any       # float32 [L, 3]
    area: Any           # float32 [L]
    normal: Any         # float32 [L, 3]

    @property
    def count(self) -> int:
        return self.position.shape[0]


@_register
@dataclasses.dataclass
class Camera:
    """Thin-lens camera frustum (scene/ioCamera.h:64-90 + shaders/camera.cu).

    Unlike the reference, `lens_radius` is actually wired to the device camera
    (the reference never uploads it, so DoF is silently disabled —
    Director.cpp:36 zero-init; SURVEY §7.4 quirk 2).  All fields are
    differentiable leaves.
    """

    origin: Any         # float32 [3]
    lower_left: Any     # float32 [3]
    horizontal: Any     # float32 [3]
    vertical: Any       # float32 [3]
    u: Any              # float32 [3]
    v: Any              # float32 [3]
    w: Any              # float32 [3]
    lens_radius: Any    # float32 scalar
    time0: Any          # float32 scalar
    time1: Any          # float32 scalar


def make_camera(lookfrom, lookat, vup, vfov_deg, aspect, aperture, focus_dist,
                t0=0.0, t1=0.0) -> Camera:
    """Build the frustum exactly as ioPerspectiveCamera does (ioCamera.h:64-90)."""
    lookfrom = jnp.asarray(lookfrom, jnp.float32)
    lookat = jnp.asarray(lookat, jnp.float32)
    vup = jnp.asarray(vup, jnp.float32)

    w = lookfrom - lookat
    w = w / jnp.linalg.norm(w)
    u = jnp.cross(vup, w)
    u = u / jnp.linalg.norm(u)
    v = jnp.cross(w, u)

    theta = jnp.asarray(vfov_deg, jnp.float32) * (np.pi / 180.0)
    half_h = jnp.tan(theta / 2.0)
    half_w = aspect * half_h

    lower_left = lookfrom - half_w * focus_dist * u - half_h * focus_dist * v - focus_dist * w
    horizontal = 2.0 * half_w * focus_dist * u
    vertical = 2.0 * half_h * focus_dist * v

    return Camera(
        origin=lookfrom,
        lower_left=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u, v=v, w=w,
        lens_radius=jnp.asarray(aperture, jnp.float32) / 2.0,
        time0=jnp.asarray(t0, jnp.float32),
        time1=jnp.asarray(t1, jnp.float32),
    )


@dataclasses.dataclass
class Scene:
    """Everything the integrator needs; a closed-over device constant.

    `sky_light` mirrors Director.cpp:523 (`skyLight = lights.empty()`):
    scenes without an area light get the books' blue-sky gradient miss shade
    (miss/miss.cu:8-21), the rest get black.
    """

    prims: Primitives
    materials: Materials
    textures: Textures
    lights: Lights
    camera: Camera
    sky_light: Any      # float32 scalar (0.0 or 1.0)
    # [n_blocks, 8] world AABBs (min xyz, max xyz, pad) of each primitive
    # block in the trace kernels' enumeration order — the kernels slab-test a
    # ray tile against these and skip whole blocks no ray in the tile can hit
    block_aabbs: Any
    n_vol: int          # static: number of volume primitives
    # static chunk plan for the intersection sweep: tuple of
    # (start, count, padded_size, prim_type, rect_axis, has_transform)
    chunk_plan: tuple = ()
    num_lights: int = 0  # static: gates the NEE code path
    # static: texture row backing each light's emission (diffuse-light
    # material albedo) or -1; ties NEE emission to the same differentiable
    # parameter as BSDF-side light hits (see diff.py)
    light_tex: tuple = ()
    # static specialization flags: which material models exist in the scene
    # (indexed by MAT_*) and which texture kinds (indexed by TEX_*).  The
    # integrator compiles only the branches a scene can reach — per-scene
    # kernel specialization, the analog of the reference building an SBT with
    # only the scene's program groups.
    mat_present: tuple = (True,) * 6
    tex_present: tuple = (True,) * 5
    # static per-prim volume slot (mirrors Primitives.vol_slot); the trace
    # kernel needs these at trace time to pick each volume prim's
    # free-flight uniform row
    vol_slots_static: tuple = ()
    # static: True when some emissive primitive is NOT registered as a
    # light (no matching Lights row, Primitives.light_row_p == -1 — e.g. an
    # emissive sphere, or a rect never passed to add_light).  MIS weighting
    # of BSDF-sampled light hits must then identify the hit row per prim
    # even in single-light scenes.  Every reference scene registers all its
    # emissives, so the closed-form single-light path stays on for them.
    emissives_unregistered: bool = False


# n_vol / chunk_plan / num_lights / light_tex are static aux data (they shape
# the jitted program); everything else is traced leaves.
def _scene_flatten(s: Scene):
    return (
        (s.prims, s.materials, s.textures, s.lights, s.camera, s.sky_light,
         s.block_aabbs),
        (s.n_vol, s.chunk_plan, s.num_lights, s.light_tex, s.mat_present,
         s.tex_present, s.vol_slots_static, s.emissives_unregistered),
    )


def _scene_unflatten(aux, leaves):
    return Scene(*leaves, n_vol=aux[0], chunk_plan=aux[1], num_lights=aux[2],
                 light_tex=aux[3], mat_present=aux[4], tex_present=aux[5],
                 vol_slots_static=aux[6], emissives_unregistered=aux[7])


jax.tree_util.register_pytree_node(Scene, _scene_flatten, _scene_unflatten)
