// Native host-side mesh builders for cudaparticlesfoam_tpu.
//
// The reference's tet decomposition runs inside OpenFOAM's C++
// (polyMeshTetDecomposition::findSharedBasePoint / cellTetIndices,
// consumed at src/initCuda.H:86-110); this is this build's native
// equivalent for the quality-driven base-point search — the single
// hottest host step of a cold case load (91 s of numpy temporaries at
// the TJunction coupled scale, 248k cells / 744k quad faces).  Per-face
// work is independent: OpenMP over faces, zero allocations.
//
// The arithmetic mirrors io/polymesh.py::_tet_quality expression for
// expression (same association order, f64 throughout) so the chosen
// base indices agree with the numpy reference implementation.
//
// Build: g++ -O3 -ffp-contract=off -fopenmp -shared -fPIC meshbuild.cpp -o libmeshbuild.so
// (-ffp-contract=off: FMA contraction would change results in the last
//  ulp vs the numpy reference implementation, flipping near-tied argmax)

#include <cstdint>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct V3 { double x, y, z; };

static inline V3 sub(const V3& a, const V3& b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}

static inline V3 cross(const V3& a, const V3& b) {
    return {a.y * b.z - a.z * b.y,
            a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

static inline double dot(const V3& a, const V3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

// OpenFOAM tetrahedron::quality(): signed volume over the volume of the
// regular tet sharing the circumsphere (polymesh.py:394-419).
static inline double tet_quality(const V3& apex, const V3& p0,
                                 const V3& p1, const V3& p2) {
    V3 e1 = sub(p0, apex);
    V3 e2 = sub(p1, apex);
    V3 e3 = sub(p2, apex);
    V3 c23 = cross(e2, e3);
    double det = dot(e1, c23);
    double vol = det / 6.0;
    double r1 = 0.5 * dot(e1, e1);
    double r2 = 0.5 * dot(e2, e2);
    double r3 = 0.5 * dot(e3, e3);
    V3 c31 = cross(e3, e1);
    V3 c12 = cross(e1, e2);
    double safe_det = (std::fabs(det) > 1e-300) ? det : 1e-300;
    V3 u = {(r1 * c23.x + r2 * c31.x + r3 * c12.x) / safe_det,
            (r1 * c23.y + r2 * c31.y + r3 * c12.y) / safe_det,
            (r1 * c23.z + r2 * c31.z + r3 * c12.z) / safe_det};
    double rc = std::sqrt(dot(u, u));
    if (!(std::fabs(det) > 1e-300)) rc = 1e30;
    if (rc > 1e30) rc = 1e30;
    // std::pow, NOT rc*rc*rc: numpy's rc**3 goes through libm pow and the
    // two differ in the last ulp for ~26% of inputs — enough to flip
    // argmax on the near-tied candidates of regular cells
    return vol / (8.0 / (9.0 * std::sqrt(3.0)) * std::pow(rc, 3.0) + 1e-300);
}

static inline V3 pt(const double* arr, int64_t i) {
    return {arr[3 * i], arr[3 * i + 1], arr[3 * i + 2]};
}

}  // namespace

extern "C" {

// Quality-driven per-face tet base point
// (polyMeshTetDecomposition::findSharedBasePoint semantics, the numpy
// reference being polymesh.py::face_base_points): for each face, pick
// the vertex whose fan maximizes the MINIMUM tet quality over both
// adjacent cells (owner only at boundaries).  Triangles keep base 0.
// First-maximum tie-breaking matches np.argmax.
void face_base_points(
    const double* points,        // [n_pts, 3]
    const int64_t* face_verts,   // flat vertex list
    const int64_t* face_offsets, // [nf + 1]
    const int64_t* owner,        // [nf]
    const int64_t* neighbour,    // [n_int]
    const double* cell_ctrs,     // [nc, 3]
    int64_t nf, int64_t n_int,
    int64_t* base_out)           // [nf]
{
#pragma omp parallel for schedule(dynamic, 512)
    for (int64_t f = 0; f < nf; ++f) {
        int64_t o = face_offsets[f];
        int64_t k = face_offsets[f + 1] - o;
        if (k <= 3) { base_out[f] = 0; continue; }
        V3 cc_own = pt(cell_ctrs, owner[f]);
        bool has_nei = f < n_int;
        V3 cc_nei = has_nei ? pt(cell_ctrs, neighbour[f]) : V3{0, 0, 0};
        double best_q = -1e300;
        int64_t best_c = 0;
        for (int64_t c = 0; c < k; ++c) {
            V3 b = pt(points, face_verts[o + c]);
            double q = 1e300;
            for (int64_t i = 1; i + 1 < k; ++i) {
                V3 pa = pt(points, face_verts[o + (c + i) % k]);
                V3 pb = pt(points, face_verts[o + (c + i + 1) % k]);
                double qo = tet_quality(cc_own, b, pa, pb);
                if (qo < q) q = qo;
                if (has_nei) {
                    // neighbour side sees the face reversed: swap the fan
                    double qn = tet_quality(cc_nei, b, pb, pa);
                    if (qn < q) q = qn;
                }
            }
            if (q > best_q) { best_q = q; best_c = c; }
        }
        base_out[f] = best_c;
    }
}

// Face centres and areas, OpenFOAM's two-pass scheme
// (primitiveMeshFaceCentresAndAreas: estimated centre -> triangle fan
// centroid weighted by triangle area; polymesh.py::face_centres_areas).
void face_centres_areas(
    const double* points,
    const int64_t* face_verts,
    const int64_t* face_offsets,
    int64_t nf,
    double* ctrs,                // [nf, 3] out
    double* areas)               // [nf, 3] out (area normal vectors)
{
#pragma omp parallel for schedule(dynamic, 512)
    for (int64_t f = 0; f < nf; ++f) {
        int64_t o = face_offsets[f];
        int64_t k = face_offsets[f + 1] - o;
        if (k == 3) {
            V3 p0 = pt(points, face_verts[o]);
            V3 p1 = pt(points, face_verts[o + 1]);
            V3 p2 = pt(points, face_verts[o + 2]);
            ctrs[3 * f]     = (p0.x + p1.x + p2.x) / 3.0;
            ctrs[3 * f + 1] = (p0.y + p1.y + p2.y) / 3.0;
            ctrs[3 * f + 2] = (p0.z + p1.z + p2.z) / 3.0;
            V3 n = cross(sub(p1, p0), sub(p2, p0));
            areas[3 * f]     = 0.5 * n.x;
            areas[3 * f + 1] = 0.5 * n.y;
            areas[3 * f + 2] = 0.5 * n.z;
            continue;
        }
        V3 est = {0, 0, 0};
        for (int64_t i = 0; i < k; ++i) {
            V3 p = pt(points, face_verts[o + i]);
            est.x += p.x; est.y += p.y; est.z += p.z;
        }
        est.x /= k; est.y /= k; est.z /= k;
        // mirror polymesh.py:333-346: c = p + p_next + c_est (undivided),
        // centre = sum(a*c) / (3 * sum a) — same association order
        V3 sum_n = {0, 0, 0};
        V3 sum_ac = {0, 0, 0};
        double sum_a = 0.0;
        for (int64_t i = 0; i < k; ++i) {
            V3 p1 = pt(points, face_verts[o + i]);
            V3 p2 = pt(points, face_verts[o + (i + 1) % k]);
            V3 n = cross(sub(p2, p1), sub(est, p1));
            double a = std::sqrt(dot(n, n));
            V3 c = {p1.x + p2.x + est.x,
                    p1.y + p2.y + est.y,
                    p1.z + p2.z + est.z};
            sum_n.x += n.x; sum_n.y += n.y; sum_n.z += n.z;
            sum_ac.x += a * c.x; sum_ac.y += a * c.y; sum_ac.z += a * c.z;
            sum_a += a;
        }
        if (sum_a > 1e-300) {
            double denom = 3.0 * (sum_a > 1e-300 ? sum_a : 1e-300);
            ctrs[3 * f]     = sum_ac.x / denom;
            ctrs[3 * f + 1] = sum_ac.y / denom;
            ctrs[3 * f + 2] = sum_ac.z / denom;
        } else {
            ctrs[3 * f] = est.x; ctrs[3 * f + 1] = est.y; ctrs[3 * f + 2] = est.z;
        }
        areas[3 * f]     = 0.5 * sum_n.x;
        areas[3 * f + 1] = 0.5 * sum_n.y;
        areas[3 * f + 2] = 0.5 * sum_n.z;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full tet-table build: canonicalize winding + shared-face construction +
// walk table (mesh.py::_canonicalize_winding / build_face_tables /
// _build_walk_table, which themselves replace the reference's
// HostTetMesh::getBoundaryMesh std::map loop, HostTetMesh.h:265-430).
// Bit-faithful to the numpy reference: identical association order in all
// float expressions (-ffp-contract=off), identical lexicographic face
// numbering (sort by triple key == np.unique order), identical last-write
// scatter semantics for front/back.  The hot parts of a cold case load
// at coupled scale (2.98M tets): 33 s of numpy -> ~2 s OpenMP.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <cstring>
#if defined(_OPENMP)
#include <parallel/algorithm>
#endif

namespace {

// Gmsh-order local faces: slot i opposite vertex i (mesh.py FACE_SLOTS)
static const int FACE_SLOTS[4][3] = {
    {1, 2, 3}, {2, 0, 3}, {0, 1, 3}, {0, 2, 1}};

struct KeyIdx {
    unsigned __int128 key;
    int64_t idx;
    bool operator<(const KeyIdx& o) const {
        return key != o.key ? key < o.key : idx < o.idx;
    }
};

struct KeyIdx64 {   // nv < 2^21: triple fits 63 bits (the reference's own
    uint64_t key;   // packing trick, HostTetMesh.h:279) — 2x faster sort
    int64_t idx;
    bool operator<(const KeyIdx64& o) const {
        return key != o.key ? key < o.key : idx < o.idx;
    }
};

}  // namespace

extern "C" {

void build_tet_tables(
    const double* points,      // [nv, 3]
    int64_t* tets,             // [nt, 4] — canonicalized IN PLACE
    int64_t nt, int64_t nv,
    int32_t* faces,            // [4nt, 3] out (first nf rows valid)
    int32_t* tet_faces,        // [nt, 4] out
    int32_t* face_front,       // [4nt] out (first nf valid)
    int32_t* face_back,        // [4nt] out
    int32_t* bd_face_ids,      // [4nt] out (first nbd valid)
    int32_t* bd_tet,           // [4nt] out
    int32_t* bd_slot,          // [4nt] out
    double* a_out,             // [nt, 3] out
    double* tinv_out,          // [nt, 3, 3] out
    int32_t* nbr_out,          // [nt, 4] out
    double* n_out,             // [nt, 4, 3] out
    double* dpl_out,           // [nt, 4] out
    int64_t* counts_out)       // [2] out: nf, nbd
{
    // 1) canonicalize winding: swap verts 0,1 of negative-volume tets
    //    (same f64 expression order as mesh.py::_canonicalize_winding)
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < nt; ++t) {
        V3 a = pt(points, tets[4 * t]);
        V3 b = pt(points, tets[4 * t + 1]);
        V3 c = pt(points, tets[4 * t + 2]);
        V3 d = pt(points, tets[4 * t + 3]);
        V3 cr = cross(sub(b, a), sub(c, a));
        V3 da = sub(d, a);
        double vol = da.x * cr.x + da.y * cr.y + da.z * cr.z;
        if (vol < 0.0) std::swap(tets[4 * t], tets[4 * t + 1]);
    }

    // 2+3) per-incidence sorted triples + orientation parity (the
    //    reference's 3-step sorting network), lexicographic key sort,
    //    unique faces in ascending key (== np.unique numbering).
    //    nv < 2^21 packs the triple into 63 bits (HostTetMesh.h:279);
    //    larger meshes use a 128-bit key — identical ordering.
    const int64_t m = 4 * nt;
    std::vector<int32_t> tri(3 * m);
    std::vector<unsigned char> front(m);
    std::vector<int32_t> inv(m);
    int64_t nf = 0;

    auto run_dedup = [&](auto* ki_typed) {
        using KI = std::remove_pointer_t<decltype(ki_typed)>;
        std::vector<KI> ki(m);
#pragma omp parallel for schedule(static)
        for (int64_t t = 0; t < nt; ++t) {
            for (int s = 0; s < 4; ++s) {
                int64_t j = 4 * t + s;
                int64_t v[3] = {tets[4 * t + FACE_SLOTS[s][0]],
                                tets[4 * t + FACE_SLOTS[s][1]],
                                tets[4 * t + FACE_SLOTS[s][2]]};
                bool fr = false;
                if (v[0] > v[2]) { std::swap(v[0], v[2]); fr = !fr; }
                if (v[1] > v[2]) { std::swap(v[1], v[2]); fr = !fr; }
                if (v[0] > v[1]) { std::swap(v[0], v[1]); fr = !fr; }
                tri[3 * j] = (int32_t)v[0];
                tri[3 * j + 1] = (int32_t)v[1];
                tri[3 * j + 2] = (int32_t)v[2];
                front[j] = fr;
                decltype(KI::key) key = (decltype(KI::key))(uint64_t)v[0];
                key = key * (decltype(KI::key))(uint64_t)nv
                    + (decltype(KI::key))(uint64_t)v[1];
                key = key * (decltype(KI::key))(uint64_t)nv
                    + (decltype(KI::key))(uint64_t)v[2];
                ki[j].key = key;
                ki[j].idx = j;
            }
        }
#if defined(_OPENMP)
        __gnu_parallel::sort(ki.begin(), ki.end());
#else
        std::sort(ki.begin(), ki.end());
#endif
        int64_t i = 0;
        while (i < m) {
            int64_t j0 = i;
            while (i < m && ki[i].key == ki[j0].key) ++i;
            const int64_t src = ki[j0].idx;      // first occurrence
            faces[3 * nf] = tri[3 * src];
            faces[3 * nf + 1] = tri[3 * src + 1];
            faces[3 * nf + 2] = tri[3 * src + 2];
            for (int64_t k = j0; k < i; ++k) inv[ki[k].idx] = (int32_t)nf;
            ++nf;
        }
    };
    if (nv < (int64_t(1) << 21)) {
        run_dedup((KeyIdx64*)nullptr);
    } else {
        run_dedup((KeyIdx*)nullptr);
    }
#pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < m; ++j) tet_faces[j] = inv[j];

    // 4) front/back (last write wins, ascending flat order like numpy)
    for (int64_t f = 0; f < nf; ++f) { face_front[f] = -1; face_back[f] = -1; }
    for (int64_t j = 0; j < m; ++j) {
        if (front[j]) face_front[inv[j]] = (int32_t)(j / 4);
        else          face_back[inv[j]] = (int32_t)(j / 4);
    }

    // 5) boundary faces: count == 1, numbered in face-id order; the single
    //    incidence gives (bd_tet, bd_slot)
    std::vector<int32_t> count(nf, 0);
    std::vector<int64_t> one_inc(nf, -1);
    for (int64_t j = 0; j < m; ++j) {
        int32_t f = inv[j];
        if (count[f]++ == 0) one_inc[f] = j;
    }
    int64_t nbd = 0;
    for (int64_t f = 0; f < nf; ++f) {
        if (count[f] == 1) {
            int32_t code = -(int32_t)(nbd + 1);
            if (face_front[f] == -1) face_front[f] = code;
            if (face_back[f] == -1) face_back[f] = code;
            bd_face_ids[nbd] = (int32_t)f;
            bd_tet[nbd] = (int32_t)(one_inc[f] / 4);
            bd_slot[nbd] = (int32_t)(one_inc[f] % 4);
            ++nbd;
        }
    }
    counts_out[0] = nf;
    counts_out[1] = nbd;

    // 6) walk table: A, Tinv (adjugate, mesh.py::_inv3 expression order),
    //    neighbor codes, outward unit face planes
#pragma omp parallel for schedule(static)
    for (int64_t t = 0; t < nt; ++t) {
        V3 pa = pt(points, tets[4 * t]);
        V3 pb = pt(points, tets[4 * t + 1]);
        V3 pc = pt(points, tets[4 * t + 2]);
        V3 pd = pt(points, tets[4 * t + 3]);
        a_out[3 * t] = pa.x; a_out[3 * t + 1] = pa.y; a_out[3 * t + 2] = pa.z;
        // m columns are (b-a, c-a, d-a): m[r][c]
        double M[3][3] = {
            {pb.x - pa.x, pc.x - pa.x, pd.x - pa.x},
            {pb.y - pa.y, pc.y - pa.y, pd.y - pa.y},
            {pb.z - pa.z, pc.z - pa.z, pd.z - pa.z},
        };
        const double A_ = M[1][1] * M[2][2] - M[1][2] * M[2][1];
        const double B_ = M[0][2] * M[2][1] - M[0][1] * M[2][2];
        const double C_ = M[0][1] * M[1][2] - M[0][2] * M[1][1];
        const double D_ = M[1][2] * M[2][0] - M[1][0] * M[2][2];
        const double E_ = M[0][0] * M[2][2] - M[0][2] * M[2][0];
        const double F_ = M[0][2] * M[1][0] - M[0][0] * M[1][2];
        const double G_ = M[1][0] * M[2][1] - M[1][1] * M[2][0];
        const double H_ = M[0][1] * M[2][0] - M[0][0] * M[2][1];
        const double I_ = M[0][0] * M[1][1] - M[0][1] * M[1][0];
        const double det = M[0][0] * A_ + M[0][1] * D_ + M[0][2] * G_;
        const double adj[9] = {A_, B_, C_, D_, E_, F_, G_, H_, I_};
        for (int k = 0; k < 9; ++k) tinv_out[9 * t + k] = adj[k] / det;

        for (int s = 0; s < 4; ++s) {
            // neighbor: the faceinfo side that isn't me
            int32_t f = tet_faces[4 * t + s];
            int32_t fr = face_front[f], bk = face_back[f];
            nbr_out[4 * t + s] = (fr == (int32_t)t) ? bk : fr;
            // outward face plane
            V3 q0 = pt(points, tets[4 * t + FACE_SLOTS[s][0]]);
            V3 q1 = pt(points, tets[4 * t + FACE_SLOTS[s][1]]);
            V3 q2 = pt(points, tets[4 * t + FACE_SLOTS[s][2]]);
            V3 nn = cross(sub(q1, q0), sub(q2, q0));
            double nrm = std::sqrt(nn.x * nn.x + nn.y * nn.y + nn.z * nn.z);
            nn.x /= nrm; nn.y /= nrm; nn.z /= nrm;
            n_out[12 * t + 3 * s] = nn.x;
            n_out[12 * t + 3 * s + 1] = nn.y;
            n_out[12 * t + 3 * s + 2] = nn.z;
            dpl_out[4 * t + s] = nn.x * q0.x + nn.y * q0.y + nn.z * q0.z;
        }
    }
}

}  // extern "C"
