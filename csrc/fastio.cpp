// Native I/O runtime for cudaparticlesfoam_tpu.
//
// The reference's host-side runtime is C++ (ascii VTU writers in
// cuda/utils.cpp, OpenFOAM file parsing via the OpenFOAM libs); this is
// this build's native equivalent, exposed through ctypes (no pybind11
// needed).  Two hot paths:
//   * write_particles_vtu: the exact reference VTU schema
//     (utils.cpp:144-283) at fwrite speed — a 4M-particle frame is ~20x
//     faster than the numpy text path.
//   * parse_numbers: whitespace/paren-delimited ascii number scanning for
//     polyMesh/field files (points/faces/owner/U), replacing Python
//     str.split for multi-million-element meshes.
//
// Build: g++ -O3 -march=native -shared -fPIC fastio.cpp -o libfastio.so

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// fast ascii number parsing
// ---------------------------------------------------------------------------

// Parse all numbers in `text` (treating '(', ')' and whitespace as
// separators) into out[0..cap).  Returns the count parsed (may exceed cap;
// only cap values are stored — call once with cap=0... no: we return count
// and the caller sizes accordingly via two-pass or generous bound).
long parse_doubles(const char* text, long len, double* out, long cap) {
    long n = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end) {
        char c = *p;
        if (c == '(' || c == ')' || c == ',' || c == ';' ||
            c == ' ' || c == '\t' || c == '\n' || c == '\r') {
            ++p;
            continue;
        }
        char* q;
        double v = strtod(p, &q);
        if (q == p) { ++p; continue; }   // not a number: skip one char
        if (n < cap) out[n] = v;
        ++n;
        p = q;
    }
    return n;
}

long parse_longs(const char* text, long len, long long* out, long cap) {
    long n = 0;
    const char* p = text;
    const char* end = text + len;
    while (p < end) {
        char c = *p;
        if (c == '(' || c == ')' || c == ',' || c == ';' ||
            c == ' ' || c == '\t' || c == '\n' || c == '\r') {
            ++p;
            continue;
        }
        char* q;
        long long v = strtoll(p, &q, 10);
        if (q == p) { ++p; continue; }
        if (n < cap) out[n] = v;
        ++n;
        p = q;
    }
    return n;
}

// ---------------------------------------------------------------------------
// VTU particle frame writer (reference schema, utils.cpp:144-283)
// ---------------------------------------------------------------------------

static void write_int_array(FILE* fp, const char* name, const int* vals,
                            long n) {
    fprintf(fp,
            "<DataArray NumberOfComponents='1' type='Int32' Name='%s' "
            "format='ascii'>\n",
            name);
    for (long i = 0; i < n; ++i) fprintf(fp, "%d\n", vals[i]);
    fprintf(fp, "</DataArray>\n");
}

// Returns 0 on success.  ke_quirk=1 reproduces the reference's inverted
// KEs write (utils.cpp:243-248: nonzero KE prints 0.0).
int write_particles_vtu(const char* path,
                        const double* pos,      // [n,3]
                        const double* vel,      // [n,3]
                        const int* tet_ids,     // [n]
                        const int* types,       // [n] (active flags)
                        const int* convex_ids,  // [n] or NULL
                        long n,
                        int ke_quirk) {
    FILE* fp = fopen(path, "w");
    if (!fp) return 1;
    fprintf(fp,
            "<VTKFile type='UnstructuredGrid' version='1.0' "
            "byte_order='LittleEndian' header_type='UInt64'>\n"
            "<UnstructuredGrid>\n"
            "<Piece NumberOfCells='%ld' NumberOfPoints='%ld'>\n"
            "<Points>\n"
            "<DataArray NumberOfComponents='3' type='Float64' "
            "Name='Position' format='ascii'>\n",
            n, n);
    for (long i = 0; i < n; ++i)
        fprintf(fp, "%.15f %.15f %.15f\n", pos[3 * i], pos[3 * i + 1],
                pos[3 * i + 2]);
    fprintf(fp, "</DataArray>\n</Points>\n<PointData>\n");

    write_int_array(fp, "ParticleType", types, n);
    fprintf(fp,
            "<DataArray NumberOfComponents='1' type='Int32' "
            "Name='ParticleID' format='ascii'>\n");
    for (long i = 0; i < n; ++i) fprintf(fp, "%ld\n", i);
    fprintf(fp, "</DataArray>\n");
    write_int_array(fp, "ParticleTetID", tet_ids, n);
    if (convex_ids) write_int_array(fp, "ConvexTetID", convex_ids, n);

    fprintf(fp,
            "<DataArray NumberOfComponents='3' type='Float32' Name='vels' "
            "format='ascii'>\n");
    for (long i = 0; i < n; ++i) {
        double vx = vel[3 * i], vy = vel[3 * i + 1], vz = vel[3 * i + 2];
        if (std::isnan(vx))
            fprintf(fp, "%f %f %f\n", 0.0, 0.0, 0.0);
        else
            fprintf(fp, "%f %f %f\n", vx, vy, vz);
    }
    fprintf(fp, "</DataArray>\n");

    fprintf(fp,
            "<DataArray NumberOfComponents='1' type='Float32' Name='KEs' "
            "format='ascii'>\n");
    for (long i = 0; i < n; ++i) {
        double vx = vel[3 * i], vy = vel[3 * i + 1], vz = vel[3 * i + 2];
        double ke = 0.5 * (vx * vx + vy * vy + vz * vz);
        if (ke_quirk && ke != 0.0)
            fprintf(fp, "%f\n", 0.0);
        else
            fprintf(fp, "%f\n", ke);
    }
    fprintf(fp, "</DataArray>\n</PointData>\n<Cells>\n");

    fprintf(fp, "<DataArray type='Int32' Name='connectivity' format='ascii'>\n");
    for (long i = 0; i < n; ++i) fprintf(fp, "%ld\n", i);
    fprintf(fp, "</DataArray>\n");
    fprintf(fp, "<DataArray type='Int32' Name='offsets' format='ascii'>\n");
    for (long i = 0; i < n; ++i) fprintf(fp, "%ld\n", i + 1);
    fprintf(fp, "</DataArray>\n");
    fprintf(fp, "<DataArray type='UInt8' Name='types' format='ascii'>\n");
    for (long i = 0; i < n; ++i) fputs("1\n", fp);
    fprintf(fp, "</DataArray>\n</Cells>\n</Piece>\n</UnstructuredGrid>\n"
                "</VTKFile>\n");
    fclose(fp);
    return 0;
}

// OBJ point dump (utils.cpp:96-142)
int write_particles_obj(const char* path, const double* pos, long n) {
    FILE* fp = fopen(path, "w");
    if (!fp) return 1;
    for (long i = 0; i < n; ++i)
        fprintf(fp, "v %.15f %.15f %.15f\n", pos[3 * i], pos[3 * i + 1],
                pos[3 * i + 2]);
    fclose(fp);
    return 0;
}

}  // extern "C"
