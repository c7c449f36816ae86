// Linear-octree builder for the AMR grid (native runtime component).
//
// Rebuilds the reference's host-side tree construction (reference:
// src/octree_mod.f90:460-618 amr_build_tree, :619-697 amr_build_neighbors)
// as a C++ library: insert leaves from a flat (x, y, z, level) list, derive
// internal cells, leaf maps, and the 6-face same-level neighbor table with
// ancestor-gap suppression.  For multi-million-leaf boxes (IllustrisTNG ~6M
// leaves) the neighbor build is 36M tree descents -- native code keeps grid
// construction in seconds.
//
// The resulting flat SoA arrays (parent/children/level/center/half-width/
// leaf maps/neighbors) are exactly the gather-friendly layout the TPU
// traversal kernel consumes.
//
// C ABI (ctypes): build -> handle; getters copy into caller buffers.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <map>
#include <vector>

namespace {

struct Octree {
    int ncells = 0;
    int nleaf = 0;
    int levelmax = 0;
    double xmin, xmax, ymin, ymax, zmin, zmax;
    std::vector<int32_t> parent;          // ncells
    std::vector<int32_t> children;        // ncells * 8
    std::vector<int32_t> level;           // ncells
    std::vector<double> cx, cy, cz, ch;   // ncells
    std::vector<int32_t> ileaf;           // ncells (1-based leaf id; 0 = internal)
    std::vector<int32_t> icell_of_leaf;   // nleaf
    std::vector<int32_t> neighbor;        // ncells * 6

    int add_cell(int par_idx, int lev, double x, double y, double z, double h) {
        parent.push_back(par_idx);
        for (int i = 0; i < 8; ++i) children.push_back(0);
        level.push_back(lev);
        cx.push_back(x); cy.push_back(y); cz.push_back(z); ch.push_back(h);
        ileaf.push_back(0);
        return ++ncells;   // 1-based index
    }
};

std::map<int64_t, Octree*> g_instances;
int64_t g_next = 1;

inline int octant(const Octree& T, int icell, double x, double y, double z) {
    int io = 0;
    if (x >= T.cx[icell - 1]) io += 1;
    if (y >= T.cy[icell - 1]) io += 2;
    if (z >= T.cz[icell - 1]) io += 4;
    return io;   // 0..7
}

// Descend to the cell at exactly target_level containing (x,y,z)
// (octree_mod.f90:amr_find_cell_at_level). Returns 0 if outside.
int find_cell_at_level(const Octree& T, double x, double y, double z,
                       int target_level) {
    if (x < T.xmin || x > T.xmax || y < T.ymin || y > T.ymax ||
        z < T.zmin || z > T.zmax) return 0;
    int icell = 1;
    for (;;) {
        if (T.level[icell - 1] >= target_level) return icell;
        if (T.ileaf[icell - 1] > 0) return icell;
        int io = octant(T, icell, x, y, z);
        int child = T.children[(icell - 1) * 8 + io];
        if (child == 0) return icell;
        icell = child;
    }
}

bool is_ancestor(const Octree& T, int anc, int desc) {
    int c = desc;
    while (c > 0) {
        c = T.parent[c - 1];
        if (c == anc) return true;
    }
    return false;
}

}  // namespace

extern "C" {

int64_t lart_octree_build(int32_t nleaf, const double* xl, const double* yl,
                          const double* zl, const int32_t* lev,
                          const double* box /* [6]: xmin xmax ymin ymax zmin zmax */) {
    Octree* T = new Octree();
    T->xmin = box[0]; T->xmax = box[1];
    T->ymin = box[2]; T->ymax = box[3];
    T->zmin = box[4]; T->zmax = box[5];
    T->nleaf = nleaf;
    const double Lx = T->xmax - T->xmin;
    // root cell (level 0) spans the full box; half-width from x extent
    // (the reference assumes a cubic box, amr_grid%L_box = xrange)
    T->add_cell(0, 0, 0.5 * (T->xmin + T->xmax), 0.5 * (T->ymin + T->ymax),
                0.5 * (T->zmin + T->zmax), 0.5 * Lx);

    size_t est = (size_t)(nleaf * 1.3) + 64;
    T->parent.reserve(est); T->children.reserve(est * 8);
    T->level.reserve(est);
    T->cx.reserve(est); T->cy.reserve(est); T->cz.reserve(est);
    T->ch.reserve(est); T->ileaf.reserve(est);
    T->icell_of_leaf.resize(nleaf, 0);

    // insert each leaf: descend from root, creating internal cells on the way
    for (int32_t i = 0; i < nleaf; ++i) {
        int target = lev[i];
        if (target > T->levelmax) T->levelmax = target;
        int icell = 1;
        while (T->level[icell - 1] < target) {
            int io = octant(*T, icell, xl[i], yl[i], zl[i]);
            int child = T->children[(icell - 1) * 8 + io];
            if (child == 0) {
                int l = T->level[icell - 1] + 1;
                double h = T->ch[icell - 1] * 0.5;
                double ncx = T->cx[icell - 1] + ((io & 1) ? h : -h);
                double ncy = T->cy[icell - 1] + ((io & 2) ? h : -h);
                double ncz = T->cz[icell - 1] + ((io & 4) ? h : -h);
                child = T->add_cell(icell, l, ncx, ncy, ncz, h);
                T->children[(icell - 1) * 8 + io] = child;
            }
            icell = child;
        }
        T->ileaf[icell - 1] = i + 1;           // 1-based leaf id
        T->icell_of_leaf[i] = icell;
    }

    // neighbor table (octree_mod.f90:619-697): query the would-be same-level
    // neighbor's CENTER one full cell width past the face; suppress ancestors
    T->neighbor.assign((size_t)T->ncells * 6, 0);
    for (int icell = 1; icell <= T->ncells; ++icell) {
        double x = T->cx[icell - 1], y = T->cy[icell - 1], z = T->cz[icell - 1];
        double hp = 2.0 * T->ch[icell - 1];
        int tl = T->level[icell - 1];
        const double qx[6] = {x + hp, x - hp, x, x, x, x};
        const double qy[6] = {y, y, y + hp, y - hp, y, y};
        const double qz[6] = {z, z, z, z, z + hp, z - hp};
        for (int f = 0; f < 6; ++f) {
            if (qx[f] < T->xmin || qx[f] > T->xmax ||
                qy[f] < T->ymin || qy[f] > T->ymax ||
                qz[f] < T->zmin || qz[f] > T->zmax) continue;
            int nb = find_cell_at_level(*T, qx[f], qy[f], qz[f], tl);
            if (nb > 0 && nb != icell && is_ancestor(*T, nb, icell)) nb = 0;
            T->neighbor[(size_t)(icell - 1) * 6 + f] = nb;
        }
    }

    int64_t h = g_next++;
    g_instances[h] = T;
    return h;
}

int32_t lart_octree_ncells(int64_t h) { return g_instances.at(h)->ncells; }
int32_t lart_octree_levelmax(int64_t h) { return g_instances.at(h)->levelmax; }

void lart_octree_fill(int64_t h, int32_t* parent, int32_t* children,
                      int32_t* level, double* cx, double* cy, double* cz,
                      double* ch, int32_t* ileaf, int32_t* icell_of_leaf,
                      int32_t* neighbor) {
    const Octree* T = g_instances.at(h);
    size_t n = T->ncells;
    std::memcpy(parent, T->parent.data(), n * 4);
    std::memcpy(children, T->children.data(), n * 8 * 4);
    std::memcpy(level, T->level.data(), n * 4);
    std::memcpy(cx, T->cx.data(), n * 8);
    std::memcpy(cy, T->cy.data(), n * 8);
    std::memcpy(cz, T->cz.data(), n * 8);
    std::memcpy(ch, T->ch.data(), n * 8);
    std::memcpy(ileaf, T->ileaf.data(), n * 4);
    std::memcpy(icell_of_leaf, T->icell_of_leaf.data(), (size_t)T->nleaf * 4);
    std::memcpy(neighbor, T->neighbor.data(), n * 6 * 4);
}

void lart_octree_free(int64_t h) {
    auto it = g_instances.find(h);
    if (it != g_instances.end()) { delete it->second; g_instances.erase(it); }
}

}  // extern "C"
