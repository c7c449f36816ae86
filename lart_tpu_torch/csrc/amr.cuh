// The octree AMR grid on the device, and the cell lookups shared by K2
// (the birth cell), K4 (the cell-local core-skip and the per-leaf gathers),
// K7 (the AMR sightline) and K8 (the AMR flight), as walk.cuh is shared by
// K5 and K7.
//
// Replaces lart_tpu/transport/engine.py:548 amr_find_cell, :359
// amr_descend_from_face and the per-leaf gathers of :279-356 (_leaf_of,
// _leaf_gather and the AMR branches of cell_voigt_a, cell_Dfreq,
// cell_rhokap, cell_rhokapD and cell_velocity_dot).  A lane's cell index ic
// is an octree node; its leaf is ileaf[ic], -1 for a gap cell (a missing
// octant of an internal node), which has no gas, no dust, no velocity and
// the reference Doppler width and damping.  The finest-level map, where the
// host built one (2^levelmax)^3 voxels, answers "which cell holds this
// point" with one gather; without it the lookup descends octant by octant
// from the root, or from the neighbor across the face just crossed, at most
// levelmax + 1 levels (a RAMSES-depth tree: (2^levelmax)^3 too large for a
// table).  Every expression keeps lart_tpu's order: the bin of a voxel is
// floor((x - xmin) / dxf) with dxf the f32 voxel width, the nudge past a
// face half a voxel, the clamp into the neighbor node a quarter voxel inside
// its faces.
#pragma once

// lart_tpu_torch/grid/octree.py AmrC mirrors this layout field for field;
// lart_amr_grid_size() lets it check the size.  ncells == 0 on a Cartesian
// grid, where no kernel reads the rest.
struct AmrGrid {
  const int* children;  // (ncells, 8), -1 none
  const float* node_cx; // (ncells,) node centres and half-widths
  const float* node_cy;
  const float* node_cz;
  const float* node_ch;
  const int* ileaf;     // (ncells,) leaf id, -1 for internal and gap cells
  const int* neighbor;  // (ncells, 6) faces +x -x +y -y +z -z, -1 outside
  const int* fine_map;  // (nf, nf, nf) deepest node of each voxel, or null
  const float* Dfreq;   // (nleaf,) Doppler width; null at uniform temperature
  const float* voigt_a; // (nleaf,) damping parameter; null likewise
  int ncells;
  int levelmax;
  int nf;               // the fine map's width, 0 without one
  float xmin, ymin, zmin;
  float dxf;            // the fine voxel's width, f32
};

__device__ inline int amr_clip_cell(const AmrGrid& g, int ic) {
  return min(max(ic, 0), g.ncells - 1);
}

// _leaf_of: the leaf of node ic (clamped like jnp.take mode='clip')
__device__ inline int amr_leaf(const AmrGrid& g, int ic) {
  return __ldg(&g.ileaf[amr_clip_cell(g, ic)]);
}

// _leaf_gather: a per-leaf value, dflt in a gap (il < 0)
__device__ inline float leaf_gather(const float* a, int il, float dflt) {
  return il >= 0 ? __ldg(&a[il]) : dflt;
}

// the fine map's voxel of (x, y, z) along one axis, clamped
__device__ inline int amr_voxel(const AmrGrid& g, float v, float vmin) {
  const int i = (int)floorf((v - vmin) / g.dxf);
  return min(max(i, 0), g.nf - 1);
}

__device__ inline int amr_fine_lookup(const AmrGrid& g, float x, float y, float z) {
  const int ii = amr_voxel(g, x, g.xmin), jj = amr_voxel(g, y, g.ymin),
            kk = amr_voxel(g, z, g.zmin);
  return __ldg(&g.fine_map[(ii * g.nf + jj) * g.nf + kk]);
}

// the octant descent from node cur to the deepest node holding (x, y, z);
// fixed >= 0 pins the octant bit of that axis to fbit (the face just
// crossed fixes it topologically)
__device__ inline int amr_descend(const AmrGrid& g, int cur, float x, float y, float z,
                                  int fixed, int fbit) {
  for (int l = 0; l <= g.levelmax; ++l) {
    const int c = amr_clip_cell(g, cur);
    if (__ldg(&g.ileaf[c]) >= 0) break;
    const int bx = fixed == 0 ? fbit : (x >= __ldg(&g.node_cx[c]) ? 1 : 0);
    const int by = fixed == 1 ? fbit : (y >= __ldg(&g.node_cy[c]) ? 1 : 0);
    const int bz = fixed == 2 ? fbit : (z >= __ldg(&g.node_cz[c]) ? 1 : 0);
    const int child = __ldg(&g.children[c * 8 + bx + 2 * by + 4 * bz]);
    if (child < 0) break;
    cur = child;
  }
  return cur;
}

// amr_find_cell (engine.py:548-578): the deepest node holding (x, y, z)
__device__ inline int amr_find_cell(const AmrGrid& g, float x, float y, float z) {
  if (g.fine_map) return amr_fine_lookup(g, x, y, z);
  return amr_descend(g, 0, x, y, z, -1, 0);
}

// amr_descend_from_face (engine.py:359-418): the cell entered across face
// (0 +x, 1 -x, 2 +y, 3 -y, 4 +z, 5 -z) from the neighbor node nb at the
// face point (x, y, z).  With the fine map: nudge half a voxel past the
// face, clamp into nb's box a quarter voxel inside its faces (f32 rounding
// at the face plane must not floor back into the cell being left), one
// gather.  Without: descend from nb with the face-normal bit fixed.
__device__ inline int amr_descend_from_face(const AmrGrid& g, int nb, int face, float x,
                                            float y, float z) {
  const int axis = face >> 1;
  if (g.fine_map) {
    const float sgn = (face & 1) == 0 ? 1.0f : -1.0f;
    const float nudge = 0.5f * g.dxf * sgn;
    float q[3] = {x + (axis == 0 ? nudge : 0.0f), y + (axis == 1 ? nudge : 0.0f),
                  z + (axis == 2 ? nudge : 0.0f)};
    const int c = amr_clip_cell(g, nb);
    const float nc[3] = {__ldg(&g.node_cx[c]), __ldg(&g.node_cy[c]), __ldg(&g.node_cz[c])};
    const float nch = __ldg(&g.node_ch[c]);
    const float pad = 0.25f * g.dxf;
#pragma unroll
    for (int a = 0; a < 3; ++a) q[a] = fminf(fmaxf(q[a], nc[a] - nch + pad), nc[a] + nch - pad);
    return amr_fine_lookup(g, q[0], q[1], q[2]);
  }
  // face 0 (+x exit) enters the -x half of the next cell: bit 0; face 1: 1
  return amr_descend(g, nb, x, y, z, axis, face & 1);
}
