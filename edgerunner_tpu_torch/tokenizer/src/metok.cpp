// metok — EdgeBreaker-family triangle-mesh tokenizer for edgerunner-tpu.
//
// Clean-room C++17 implementation of the tokenization scheme used by the
// reference framework's "meto" library (see its meto/include/meto:
// mesh.h, engine_lr_absco.h, engine_lr.h, engine_clers.h for the behavioral
// spec). Exposed through a plain C ABI consumed from Python via ctypes
// (no pybind11 dependency).
//
// Behavioral contract (must hold for token-stream parity with the reference):
//  * vertices are quantized to integer bins with min(int((x+1)*bins/2), bins-1)
//  * half-edge j of a triangle (a,b,c) has tip=tri[j], src=tri[j+1], dst=tri[j+2]
//  * twins are linked through the unordered (min,max) vertex-id edge key; a
//    third half-edge on the same key marks the mesh non-manifold and is kept
//    as a border edge
//  * per-face half-edges are sorted border-first, then by |tip - twin.tip|
//  * faces are sorted by quantized center (y,z,x), components are numbered by
//    BFS seeded in that order, then faces are re-sorted by (component, center)
//  * traversal emits ops L/R/BOM (LR engines) or C/L/E/R/S/BOM/EOM (CLERS),
//    flipping faces on-the-fly when winding disagrees with the entry edge
//
// Intentional quirks preserved from the spec (do not "fix"):
//  * the half-edge comparator is not a strict weak ordering when both edges
//    are border edges; with 3 elements libstdc++ std::sort is still
//    deterministic, and parity requires the same comparator
//  * float/double promotion in undiscrete() and face centers follows the
//    reference expression shapes exactly

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <map>
#include <queue>
#include <tuple>
#include <unordered_set>
#include <utility>
#include <vector>

namespace metok {

// ---------------------------------------------------------------------------
// Quantized mesh with half-edge connectivity
// ---------------------------------------------------------------------------

struct QVert {
    int x = 0, y = 0, z = 0;
    int id = -1;
    int seen = 0;

    QVert() = default;
    QVert(int x_, int y_, int z_, int id_ = -1) : x(x_), y(y_), z(z_), id(id_) {}

    static QVert quantize(float fx, float fy, float fz, int bins, int id) {
        QVert q;
        q.x = std::min(int((fx + 1) * bins / 2), bins - 1);
        q.y = std::min(int((fy + 1) * bins / 2), bins - 1);
        q.z = std::min(int((fz + 1) * bins / 2), bins - 1);
        q.id = id;
        return q;
    }

    // bin center, mapped back to [-1, 1] (float->double->float as in spec)
    void undiscrete(int bins, float out[3]) const {
        out[0] = float((float(x) + 0.5) / bins * 2 - 1);
        out[1] = float((float(y) + 0.5) / bins * 2 - 1);
        out[2] = float((float(z) + 0.5) / bins * 2 - 1);
    }

    QVert operator+(const QVert& o) const { return QVert(x + o.x, y + o.y, z + o.z); }
    QVert operator-(const QVert& o) const { return QVert(x - o.x, y - o.y, z - o.z); }
};

struct Tri;

struct HEdge {
    QVert* tip = nullptr;   // vertex opposite this edge in its triangle
    QVert* src = nullptr;   // edge start
    QVert* dst = nullptr;   // edge end
    Tri* tri = nullptr;     // owning triangle
    HEdge* nxt = nullptr;   // next half-edge in the triangle
    HEdge* prv = nullptr;   // previous half-edge in the triangle
    HEdge* twin = nullptr;  // opposite half-edge (nullptr at borders)
};

static inline float tip_gap(const HEdge* e) {
    // distance between this edge's tip and its twin's tip (quantized coords)
    float dx = float(e->twin->tip->x - e->tip->x);
    float dy = float(e->twin->tip->y - e->tip->y);
    float dz = float(e->twin->tip->z - e->tip->z);
    return std::sqrt(dx * dx + dy * dy + dz * dz);
}

// border edges first; interior edges ordered by tip gap.
// NOTE: not a strict weak ordering for two border edges — kept for parity.
static inline bool hedge_before(const HEdge* a, const HEdge* b) {
    if (a->twin == nullptr) return true;
    if (b->twin == nullptr) return false;
    return tip_gap(a) < tip_gap(b);
}

struct Tri {
    QVert* v[3];
    HEdge* e[3];
    int id = -1;
    int comp = -1;  // connected-component index
    int seen = 0;
    float cx = 0, cy = 0, cz = 0;  // quantized centroid

    void flip() {
        for (int j = 0; j < 3; j++) {
            std::swap(e[j]->src, e[j]->dst);
            std::swap(e[j]->nxt, e[j]->prv);
        }
    }
};

// (component, center-yzx) face order
static inline bool tri_before(const Tri* a, const Tri* b) {
    if (a->comp != b->comp) return a->comp < b->comp;
    if (a->cy != b->cy) return a->cy < b->cy;
    if (a->cz != b->cz) return a->cz < b->cz;
    return a->cx < b->cx;
}

class HalfEdgeMesh {
public:
    std::vector<QVert*> verts;
    std::vector<Tri*> tris;
    int bins;
    bool verbose;
    bool non_manifold = false;

    HalfEdgeMesh(const float* v, int nv, const int* f, int nf, int bins_, bool verbose_)
        : bins(bins_), verbose(verbose_) {
        verts.reserve(nv);
        for (int i = 0; i < nv; i++) {
            verts.push_back(new QVert(QVert::quantize(v[3 * i], v[3 * i + 1], v[3 * i + 2], bins, i)));
        }

        std::map<std::pair<int, int>, HEdge*> open_edges;  // edge key -> unmatched half-edge
        tris.reserve(nf);
        for (int i = 0; i < nf; i++) {
            const int* tri = f + 3 * i;
            Tri* t = new Tri();
            t->id = i;
            for (int j = 0; j < 3; j++) {
                HEdge* e = new HEdge();
                e->tip = verts[tri[j]];
                e->src = verts[tri[(j + 1) % 3]];
                e->dst = verts[tri[(j + 2) % 3]];
                e->tri = t;
                t->v[j] = verts[tri[j]];
                t->e[j] = e;
                int a = tri[(j + 1) % 3], b = tri[(j + 2) % 3];
                std::pair<int, int> key = a < b ? std::make_pair(a, b) : std::make_pair(b, a);
                auto it = open_edges.find(key);
                if (it == open_edges.end()) {
                    open_edges[key] = e;
                } else if (it->second == nullptr) {
                    // a third half-edge on this key: non-manifold, keep as border
                    non_manifold = true;
                } else {
                    e->twin = it->second;
                    it->second->twin = e;
                    it->second = nullptr;  // key closed
                }
            }
            for (int j = 0; j < 3; j++) {
                t->e[j]->nxt = t->e[(j + 1) % 3];
                t->e[j]->prv = t->e[(j + 2) % 3];
            }
            t->cx = float(t->v[0]->x + t->v[1]->x + t->v[2]->x) / 3.0;
            t->cy = float(t->v[0]->y + t->v[1]->y + t->v[2]->y) / 3.0;
            t->cz = float(t->v[0]->z + t->v[1]->z + t->v[2]->z) / 3.0;
            tris.push_back(t);
        }

        // mark border vertices, then order each triangle's half-edges
        for (Tri* t : tris) {
            for (int j = 0; j < 3; j++) {
                if (t->e[j]->twin == nullptr) {
                    t->e[j]->src->seen = 1;
                    t->e[j]->dst->seen = 1;
                }
            }
            std::sort(t->e, t->e + 3, hedge_before);
        }

        // order faces by centroid, label components in that order, re-order
        std::sort(tris.begin(), tris.end(), tri_before);
        int ncomp = 0;
        for (Tri* seed : tris) {
            if (seed->comp != -1) continue;
            ncomp++;
            std::queue<Tri*> q;
            q.push(seed);
            while (!q.empty()) {
                Tri* t = q.front();
                q.pop();
                if (t->comp != -1) continue;
                t->comp = ncomp;
                for (int j = 0; j < 3; j++) {
                    if (t->e[j]->twin && t->e[j]->twin->tri->comp == -1) q.push(t->e[j]->twin->tri);
                }
            }
        }
        std::sort(tris.begin(), tris.end(), tri_before);
    }

    ~HalfEdgeMesh() {
        for (QVert* v : verts) delete v;
        for (Tri* t : tris) {
            for (int j = 0; j < 3; j++) delete t->e[j];
            delete t;
        }
    }
};

// ---------------------------------------------------------------------------
// Engines
// ---------------------------------------------------------------------------

struct EncodeResult {
    std::vector<int> tokens;
    std::vector<int> face_order;
    std::vector<int> face_type;
};

struct DecodeResult {
    std::vector<float> verts;  // flat xyz
    std::vector<int> faces;    // flat triples
    std::vector<int> face_type;
};

// fix triangle winding so that entry edge opposes its twin
static inline void orient(HEdge* c) {
    if (!(c->src->id == c->twin->dst->id && c->dst->id == c->twin->src->id)) c->tri->flip();
}

// --- LR_ABSCO: ops {L=0, R=1, BOM=2}, absolute quantized coords offset by 3 --

class EngineLRAbsco {
public:
    static constexpr int L = 0, R = 1, BOM = 2, NOPS = 3;
    int bins;
    bool verbose;
    EncodeResult out;

    EngineLRAbsco(int bins_, bool verbose_) : bins(bins_), verbose(verbose_) {}

    static int off(int c) { return c + NOPS; }
    static int unoff(int t) { return t - NOPS; }

    void emit_vertex(const QVert* v) {
        out.tokens.push_back(off(v->x));
        out.tokens.push_back(off(v->y));
        out.tokens.push_back(off(v->z));
    }

    void walk(HEdge* c, bool init) {
        c->tri->seen = 1;
        out.face_order.push_back(c->tri->id);
        if (!init) {
            orient(c);
            emit_vertex(c->tip);
        }
        bool tip_seen = c->tip->seen;
        bool left_seen = c->prv->twin == nullptr || c->prv->twin->tri->seen;
        bool right_seen = c->nxt->twin == nullptr || c->nxt->twin->tri->seen;

        if (!tip_seen) {
            // C merged into L
            c->tip->seen = 1;
            out.tokens.push_back(L);
            out.face_type.push_back(L);
            walk(c->nxt->twin, false);
        } else if (left_seen && right_seen) {
            // E merged into BOM: no token, recursion ends
            out.face_type.push_back(BOM);
        } else if (left_seen) {
            out.tokens.push_back(L);
            out.face_type.push_back(L);
            walk(c->nxt->twin, false);
        } else if (right_seen) {
            out.tokens.push_back(R);
            out.face_type.push_back(R);
            walk(c->prv->twin, false);
        } else {
            // S: walk the shorter active-boundary loop first; the other side
            // restarts as a fresh submesh
            int len_left = loop_len(c->nxt->twin, /*go_next=*/true);
            int len_right = loop_len(c->prv->twin, /*go_next=*/false);
            if (len_left < len_right) {
                out.tokens.push_back(L);
                out.face_type.push_back(L);
                walk(c->nxt->twin, false);
                submesh(c->prv->twin);
            } else {
                out.tokens.push_back(R);
                out.face_type.push_back(R);
                walk(c->prv->twin, false);
                submesh(c->nxt->twin);
            }
        }
    }

    // length of the active boundary loop reachable from e
    int loop_len(HEdge* e, bool go_next) {
        int n = 0;
        HEdge* cur = e;
        while (true) {
            n++;
            cur = go_next ? cur->nxt : cur->prv;
            while (cur->twin != nullptr && !cur->twin->tri->seen) {
                cur = go_next ? cur->twin->nxt : cur->twin->prv;
            }
            if (cur == e) break;
        }
        return n;
    }

    void submesh(HEdge* c) {
        if (c->tri->seen) return;  // holes/handles can close a loop onto itself
        out.tokens.push_back(BOM);
        emit_vertex(c->tip);
        emit_vertex(c->src);
        emit_vertex(c->dst);
        c->src->seen = 1;
        c->dst->seen = 1;
        walk(c, true);
    }

    void encode(HalfEdgeMesh& mesh) {
        for (Tri* t : mesh.tris) {
            if (t->seen) continue;
            submesh(t->e[0]);
        }
    }

    DecodeResult decode(const std::vector<int>& tk) {
        DecodeResult r;
        QVert v0, v1, v2, v;
        int nv = 0;
        auto push_vert = [&](QVert& q) {
            q.id = nv++;
            float f[3];
            q.undiscrete(bins, f);
            r.verts.insert(r.verts.end(), f, f + 3);
        };
        for (size_t i = 0; i < tk.size(); i++) {
            if (tk[i] == BOM) {
                if (i + 9 >= tk.size()) break;  // incomplete seed triangle
                v0 = QVert(unoff(tk[i + 1]), unoff(tk[i + 2]), unoff(tk[i + 3]));
                v1 = QVert(unoff(tk[i + 4]), unoff(tk[i + 5]), unoff(tk[i + 6]));
                v2 = QVert(unoff(tk[i + 7]), unoff(tk[i + 8]), unoff(tk[i + 9]));
                push_vert(v0);
                push_vert(v1);
                push_vert(v2);
                r.faces.insert(r.faces.end(), {v0.id, v1.id, v2.id});
                if (i != 0) r.face_type.push_back(BOM);
                i += 9;
            } else {
                if (tk[i] >= NOPS) break;       // expected an op
                if (i + 3 >= tk.size()) break;  // incomplete vertex
                v = QVert(unoff(tk[i + 1]), unoff(tk[i + 2]), unoff(tk[i + 3]));
                if (tk[i] == L) {
                    push_vert(v);
                    r.faces.insert(r.faces.end(), {v.id, v0.id, v2.id});
                    v1 = v0;
                    v0 = v;
                } else if (tk[i] == R) {
                    push_vert(v);
                    r.faces.insert(r.faces.end(), {v.id, v1.id, v0.id});
                    v2 = v0;
                    v0 = v;
                }
                r.face_type.push_back(tk[i]);
                i += 3;
            }
        }
        r.face_type.push_back(BOM);
        return r;
    }
};

// --- LR: ops {L=0, R=1, BOM=2}, parallelogram-residual coords ---------------

class EngineLR {
public:
    static constexpr int L = 0, R = 1, BOM = 2, NOPS = 3;
    int bins;
    bool verbose;
    EncodeResult out;

    EngineLR(int bins_, bool verbose_) : bins(bins_), verbose(verbose_) {}

    int off(int c) const {
        if (c < -bins || c >= bins) return -1;  // out-of-bound marker
        return c + bins + NOPS;
    }
    int unoff(int t) const {
        if (t < 0) return t;
        return t - bins - NOPS;
    }

    void walk(HEdge* c, bool init) {
        c->tri->seen = 1;
        out.face_order.push_back(c->tri->id);
        if (!init) {
            orient(c);
            // parallelogram prediction residual
            out.tokens.push_back(off(c->tip->x + c->twin->tip->x - c->nxt->tip->x - c->prv->tip->x));
            out.tokens.push_back(off(c->tip->y + c->twin->tip->y - c->nxt->tip->y - c->prv->tip->y));
            out.tokens.push_back(off(c->tip->z + c->twin->tip->z - c->nxt->tip->z - c->prv->tip->z));
        }
        bool tip_seen = c->tip->seen;
        bool left_seen = c->prv->twin == nullptr || c->prv->twin->tri->seen;
        bool right_seen = c->nxt->twin == nullptr || c->nxt->twin->tri->seen;

        if (!tip_seen) {
            c->tip->seen = 1;
            out.tokens.push_back(L);
            out.face_type.push_back(L);
            walk(c->nxt->twin, false);
        } else if (left_seen && right_seen) {
            out.face_type.push_back(BOM);
        } else if (left_seen) {
            out.tokens.push_back(L);
            out.face_type.push_back(L);
            walk(c->nxt->twin, false);
        } else if (right_seen) {
            out.tokens.push_back(R);
            out.face_type.push_back(R);
            walk(c->prv->twin, false);
        } else {
            // S: always take the left walk, push the right side as a submesh
            out.tokens.push_back(L);
            out.face_type.push_back(L);
            walk(c->nxt->twin, false);
            submesh(c->prv->twin);
        }
    }

    void submesh(HEdge* c) {
        out.tokens.push_back(BOM);
        out.tokens.push_back(off(c->tip->x));
        out.tokens.push_back(off(c->tip->y));
        out.tokens.push_back(off(c->tip->z));
        out.tokens.push_back(off(c->src->x - c->tip->x));
        out.tokens.push_back(off(c->src->y - c->tip->y));
        out.tokens.push_back(off(c->src->z - c->tip->z));
        out.tokens.push_back(off(c->dst->x - c->src->x));
        out.tokens.push_back(off(c->dst->y - c->src->y));
        out.tokens.push_back(off(c->dst->z - c->src->z));
        c->src->seen = 1;
        c->dst->seen = 1;
        walk(c, true);
    }

    void encode(HalfEdgeMesh& mesh) {
        for (Tri* t : mesh.tris) {
            if (t->seen) continue;
            submesh(t->e[0]);
        }
    }

    DecodeResult decode(const std::vector<int>& tk) {
        DecodeResult r;
        QVert v0, v1, v2, v, d;
        int nv = 0;
        auto push_vert = [&](QVert& q) {
            q.id = nv++;
            float f[3];
            q.undiscrete(bins, f);
            r.verts.insert(r.verts.end(), f, f + 3);
        };
        for (size_t i = 0; i < tk.size(); i++) {
            if (tk[i] == BOM) {
                if (i + 9 >= tk.size()) break;
                v0 = QVert(unoff(tk[i + 1]), unoff(tk[i + 2]), unoff(tk[i + 3]));
                v1 = QVert(v0.x + unoff(tk[i + 4]), v0.y + unoff(tk[i + 5]), v0.z + unoff(tk[i + 6]));
                v2 = QVert(v1.x + unoff(tk[i + 7]), v1.y + unoff(tk[i + 8]), v1.z + unoff(tk[i + 9]));
                push_vert(v0);
                push_vert(v1);
                push_vert(v2);
                r.faces.insert(r.faces.end(), {v0.id, v1.id, v2.id});
                if (i != 0) r.face_type.push_back(BOM);
                i += 9;
            } else {
                if (tk[i] >= NOPS) break;
                if (i + 3 >= tk.size()) break;
                d = QVert(unoff(tk[i + 1]), unoff(tk[i + 2]), unoff(tk[i + 3]));
                if (tk[i] == L) {
                    v = v0 + v2 - v1 + d;
                    push_vert(v);
                    r.faces.insert(r.faces.end(), {v.id, v0.id, v2.id});
                    v1 = v0;
                    v0 = v;
                } else if (tk[i] == R) {
                    v = v0 + v1 - v2 + d;
                    push_vert(v);
                    r.faces.insert(r.faces.end(), {v.id, v1.id, v0.id});
                    v2 = v0;
                    v0 = v;
                }
                r.face_type.push_back(tk[i]);
                i += 3;
            }
        }
        r.face_type.push_back(BOM);
        return r;
    }
};

// --- CLERS: classic EdgeBreaker, ops {C,L,E,R,S,BOM,EOM} --------------------

class EngineCLERS {
public:
    static constexpr int C = 0, L = 1, E = 2, R = 3, S = 4, BOM = 5, EOM = 6, NOPS = 7;
    int bins;
    bool verbose;
    EncodeResult out;

    EngineCLERS(int bins_, bool verbose_) : bins(bins_), verbose(verbose_) {}

    int off(int c) const { return c + bins * 2 + NOPS; }
    int unoff(int t) const { return t - bins * 2 - NOPS; }

    void walk(HEdge* c, bool init) {
        c->tri->seen = 1;
        out.face_order.push_back(c->tri->id);
        if (!init) {
            orient(c);
            out.tokens.push_back(off(c->tip->x + c->twin->tip->x - c->nxt->tip->x - c->prv->tip->x));
            out.tokens.push_back(off(c->tip->y + c->twin->tip->y - c->nxt->tip->y - c->prv->tip->y));
            out.tokens.push_back(off(c->tip->z + c->twin->tip->z - c->nxt->tip->z - c->prv->tip->z));
        }
        bool tip_seen = c->tip->seen;
        bool left_seen = c->prv->twin == nullptr || c->prv->twin->tri->seen;
        bool right_seen = c->nxt->twin == nullptr || c->nxt->twin->tri->seen;

        if (!tip_seen) {
            out.tokens.push_back(C);
            out.face_type.push_back(C);
            c->tip->seen = 1;
            walk(c->nxt->twin, false);
        } else if (left_seen && right_seen) {
            out.tokens.push_back(E);
            out.face_type.push_back(E);
        } else if (left_seen) {
            out.tokens.push_back(L);
            out.face_type.push_back(L);
            walk(c->nxt->twin, false);
        } else if (right_seen) {
            out.tokens.push_back(R);
            out.face_type.push_back(R);
            walk(c->prv->twin, false);
        } else {
            out.tokens.push_back(S);
            out.face_type.push_back(S);
            walk(c->nxt->twin, false);  // right branch
            walk(c->prv->twin, false);  // left branch
        }
    }

    void submesh(HEdge* c) {
        out.tokens.push_back(BOM);
        out.tokens.push_back(off(c->tip->x));
        out.tokens.push_back(off(c->tip->y));
        out.tokens.push_back(off(c->tip->z));
        out.tokens.push_back(off(c->src->x - c->tip->x));
        out.tokens.push_back(off(c->src->y - c->tip->y));
        out.tokens.push_back(off(c->src->z - c->tip->z));
        out.tokens.push_back(off(c->dst->x - c->src->x));
        out.tokens.push_back(off(c->dst->y - c->src->y));
        out.tokens.push_back(off(c->dst->z - c->src->z));
        c->src->seen = 1;
        c->dst->seen = 1;
        walk(c, true);
        out.tokens.push_back(EOM);
    }

    void encode(HalfEdgeMesh& mesh) {
        for (Tri* t : mesh.tris) {
            if (t->seen) continue;
            submesh(t->e[0]);
        }
    }

    DecodeResult decode(std::vector<int> tk) {  // by value: E→R rewrite mutates
        DecodeResult r;
        QVert v0, v1, v2, v, d;
        int nv = 0;
        std::vector<std::tuple<QVert, QVert, QVert>> s_stack;
        auto push_vert = [&](QVert& q) {
            q.id = nv++;
            float f[3];
            q.undiscrete(bins, f);
            r.verts.insert(r.verts.end(), f, f + 3);
        };
        for (size_t i = 0; i < tk.size(); i++) {
            if (tk[i] == BOM) {
                if (i + 9 >= tk.size()) break;
                v0 = QVert(unoff(tk[i + 1]), unoff(tk[i + 2]), unoff(tk[i + 3]));
                v1 = QVert(v0.x + unoff(tk[i + 4]), v0.y + unoff(tk[i + 5]), v0.z + unoff(tk[i + 6]));
                v2 = QVert(v1.x + unoff(tk[i + 7]), v1.y + unoff(tk[i + 8]), v1.z + unoff(tk[i + 9]));
                push_vert(v0);
                push_vert(v1);
                push_vert(v2);
                r.faces.insert(r.faces.end(), {v0.id, v1.id, v2.id});
                if (i != 0) r.face_type.push_back(E);
                i += 9;
            } else if (tk[i] == EOM) {
                continue;
            } else {
                if (tk[i] >= NOPS) break;
                bool was_e = false;
                if (tk[i] == E) {
                    if (i + 1 >= tk.size() || tk[i + 1] == EOM) continue;  // submesh terminator
                    // E closing an S branch: restore saved frame, act as R
                    r.face_type.push_back(E);
                    was_e = true;
                    tk[i] = R;
                    std::tie(v0, v1, v2) = s_stack.back();
                    s_stack.pop_back();
                }
                if (i + 3 >= tk.size()) break;
                d = QVert(unoff(tk[i + 1]), unoff(tk[i + 2]), unoff(tk[i + 3]));
                if (tk[i] == C || tk[i] == L || tk[i] == S) {
                    v = v0 + v2 - v1 + d;
                    push_vert(v);
                    r.faces.insert(r.faces.end(), {v.id, v0.id, v2.id});
                    if (tk[i] == S) s_stack.emplace_back(v0, v1, v2);
                    v1 = v0;
                    v0 = v;
                } else if (tk[i] == R) {
                    v = v0 + v1 - v2 + d;
                    push_vert(v);
                    r.faces.insert(r.faces.end(), {v.id, v1.id, v0.id});
                    v2 = v0;
                    v0 = v;
                }
                if (!was_e) r.face_type.push_back(tk[i]);
                i += 3;
            }
        }
        r.face_type.push_back(E);
        return r;
    }
};

}  // namespace metok

// ---------------------------------------------------------------------------
// Quadric-error-metric decimation (Garland & Heckbert '97 style)
//
// Replaces the vertex-clustering stand-in for the reference's decimation
// augmentation (reference: provider.py:258-263 uses a library decimater).
// Greedy edge collapses ordered by quadric cost; candidate placement picks
// the best of {v1, v2, midpoint} (no 4x4 solve — robust and within a few
// percent of optimal-placement quality for augmentation purposes).
// ---------------------------------------------------------------------------

namespace metok {

struct Quadric {
    double q[10] = {0};  // symmetric 4x4: upper triangle row-major
    void add_plane(double a, double b, double c, double d) {
        q[0] += a * a; q[1] += a * b; q[2] += a * c; q[3] += a * d;
        q[4] += b * b; q[5] += b * c; q[6] += b * d;
        q[7] += c * c; q[8] += c * d;
        q[9] += d * d;
    }
    void add(const Quadric& o) { for (int i = 0; i < 10; i++) q[i] += o.q[i]; }
    double eval(double x, double y, double z) const {
        return q[0]*x*x + 2*q[1]*x*y + 2*q[2]*x*z + 2*q[3]*x
             + q[4]*y*y + 2*q[5]*y*z + 2*q[6]*y
             + q[7]*z*z + 2*q[8]*z
             + q[9];
    }
};

struct Decimator {
    std::vector<std::array<double, 3>> V;
    std::vector<std::array<int, 3>> F;
    std::vector<Quadric> Q;
    std::vector<int> parent;          // union-find vertex remap
    std::vector<int> version;         // bumped per collapse for lazy heap entries
    std::vector<std::vector<int>> vfaces;  // faces touching each root vertex
    int live_faces = 0;

    int find(int v) {
        while (parent[v] != v) { parent[v] = parent[parent[v]]; v = parent[v]; }
        return v;
    }

    struct Cand {
        double cost;
        int a, b, va, vb;  // vertices + their versions at push time
        double px, py, pz;
        bool operator<(const Cand& o) const { return cost > o.cost; }  // min-heap
    };
    std::priority_queue<Cand> heap;

    Decimator(const float* verts, int nv, const int* faces, int nf)
        : V(nv), F(nf), Q(nv), parent(nv), version(nv, 0), vfaces(nv) {
        for (int i = 0; i < nv; i++) {
            V[i] = {verts[3*i], verts[3*i+1], verts[3*i+2]};
            parent[i] = i;
        }
        for (int i = 0; i < nf; i++) {
            F[i] = {faces[3*i], faces[3*i+1], faces[3*i+2]};
            for (int k = 0; k < 3; k++) vfaces[F[i][k]].push_back(i);
        }
        live_faces = nf;
        for (int i = 0; i < nf; i++) {
            double a, b, c, d;
            if (face_plane(i, a, b, c, d))
                for (int k = 0; k < 3; k++) Q[F[i][k]].add_plane(a, b, c, d);
        }
    }

    bool face_plane(int fi, double& a, double& b, double& c, double& d) const {
        const auto& f = F[fi];
        const auto &p0 = V[f[0]], &p1 = V[f[1]], &p2 = V[f[2]];
        double ux = p1[0]-p0[0], uy = p1[1]-p0[1], uz = p1[2]-p0[2];
        double vx = p2[0]-p0[0], vy = p2[1]-p0[1], vz = p2[2]-p0[2];
        a = uy*vz - uz*vy; b = uz*vx - ux*vz; c = ux*vy - uy*vx;
        double n = std::sqrt(a*a + b*b + c*c);
        if (n < 1e-12) return false;
        a /= n; b /= n; c /= n;
        d = -(a*p0[0] + b*p0[1] + c*p0[2]);
        return true;
    }

    void push_edge(int a, int b) {
        a = find(a); b = find(b);
        if (a == b) return;
        Quadric s = Q[a]; s.add(Q[b]);
        const auto &pa = V[a], &pb = V[b];
        double cands[3][3] = {
            {pa[0], pa[1], pa[2]},
            {pb[0], pb[1], pb[2]},
            {(pa[0]+pb[0])/2, (pa[1]+pb[1])/2, (pa[2]+pb[2])/2}};
        double best = 1e300; int bi = 2;
        for (int i = 0; i < 3; i++) {
            double c = s.eval(cands[i][0], cands[i][1], cands[i][2]);
            if (c < best) { best = c; bi = i; }
        }
        heap.push({best, a, b, version[a], version[b],
                   cands[bi][0], cands[bi][1], cands[bi][2]});
    }

    void seed_edges() {
        for (size_t i = 0; i < F.size(); i++)
            for (int k = 0; k < 3; k++)
                push_edge(F[i][k], F[i][(k + 1) % 3]);
    }

    bool face_alive(int fi) {
        int a = find(F[fi][0]), b = find(F[fi][1]), c = find(F[fi][2]);
        return a != b && b != c && a != c;
    }

    void decimate_to(int target_faces) {
        seed_edges();
        while (live_faces > target_faces && !heap.empty()) {
            Cand c = heap.top(); heap.pop();
            // lazy deletion: entry is valid only if both endpoints are still
            // roots at the versions recorded when it was pushed
            if (parent[c.a] != c.a || parent[c.b] != c.b ||
                version[c.a] != c.va || version[c.b] != c.vb)
                continue;
            int a = c.a, b = c.b;

            // collapse b into a at the chosen position; the only faces whose
            // liveness can change are those in the two rings
            std::unordered_set<int> ring(vfaces[a].begin(), vfaces[a].end());
            ring.insert(vfaces[b].begin(), vfaces[b].end());
            int before = 0;
            for (int fi : ring) if (face_alive(fi)) before++;

            V[a] = {c.px, c.py, c.pz};
            Q[a].add(Q[b]);
            parent[b] = a;
            version[a]++; version[b]++;

            std::vector<int> keep;
            keep.reserve(ring.size());
            int after = 0;
            for (int fi : ring)
                if (face_alive(fi)) { keep.push_back(fi); after++; }
            vfaces[a] = std::move(keep);
            vfaces[b].clear(); vfaces[b].shrink_to_fit();
            live_faces -= before - after;

            // refresh costs of edges around the merged vertex
            for (int fi : vfaces[a])
                for (int k = 0; k < 3; k++)
                    push_edge(F[fi][k], F[fi][(k + 1) % 3]);
        }
    }

    void extract(std::vector<float>& out_v, std::vector<int>& out_f) {
        std::vector<int> remap(V.size(), -1);
        out_v.clear(); out_f.clear();
        for (size_t i = 0; i < F.size(); i++) {
            if (!face_alive((int)i)) continue;
            int idx[3];
            for (int k = 0; k < 3; k++) {
                int v = find(F[i][k]);
                if (remap[v] < 0) {
                    remap[v] = (int)(out_v.size() / 3);
                    out_v.push_back((float)V[v][0]);
                    out_v.push_back((float)V[v][1]);
                    out_v.push_back((float)V[v][2]);
                }
                idx[k] = remap[v];
            }
            out_f.push_back(idx[0]); out_f.push_back(idx[1]); out_f.push_back(idx[2]);
        }
    }
};

}  // namespace metok

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

struct MetokBuffers {
    std::vector<int> tokens;
    std::vector<int> face_order;
    std::vector<int> face_type;
    std::vector<float> verts;
    std::vector<int> faces;
};

// backend: 0 = LR_ABSCO, 1 = LR, 2 = CLERS
void* metok_encode(int backend, int bins, int verbose, const float* verts, int nv,
                   const int* faces, int nf) {
    metok::HalfEdgeMesh mesh(verts, nv, faces, nf, bins, verbose != 0);
    auto* buf = new MetokBuffers();
    if (backend == 0) {
        metok::EngineLRAbsco eng(bins, verbose != 0);
        eng.encode(mesh);
        buf->tokens = std::move(eng.out.tokens);
        buf->face_order = std::move(eng.out.face_order);
        buf->face_type = std::move(eng.out.face_type);
    } else if (backend == 1) {
        metok::EngineLR eng(bins, verbose != 0);
        eng.encode(mesh);
        buf->tokens = std::move(eng.out.tokens);
        buf->face_order = std::move(eng.out.face_order);
        buf->face_type = std::move(eng.out.face_type);
    } else {
        metok::EngineCLERS eng(bins, verbose != 0);
        eng.encode(mesh);
        buf->tokens = std::move(eng.out.tokens);
        buf->face_order = std::move(eng.out.face_order);
        buf->face_type = std::move(eng.out.face_type);
    }
    return buf;
}

void* metok_decode(int backend, int bins, int verbose, const int* tokens, int n) {
    std::vector<int> tk(tokens, tokens + n);
    auto* buf = new MetokBuffers();
    metok::DecodeResult r;
    if (backend == 0) {
        metok::EngineLRAbsco eng(bins, verbose != 0);
        r = eng.decode(tk);
    } else if (backend == 1) {
        metok::EngineLR eng(bins, verbose != 0);
        r = eng.decode(tk);
    } else {
        metok::EngineCLERS eng(bins, verbose != 0);
        r = eng.decode(tk);
    }
    buf->verts = std::move(r.verts);
    buf->faces = std::move(r.faces);
    buf->face_type = std::move(r.face_type);
    return buf;
}

const int* metok_get_tokens(void* h, int* n) {
    auto* buf = static_cast<MetokBuffers*>(h);
    *n = (int)buf->tokens.size();
    return buf->tokens.data();
}
const int* metok_get_face_order(void* h, int* n) {
    auto* buf = static_cast<MetokBuffers*>(h);
    *n = (int)buf->face_order.size();
    return buf->face_order.data();
}
const int* metok_get_face_type(void* h, int* n) {
    auto* buf = static_cast<MetokBuffers*>(h);
    *n = (int)buf->face_type.size();
    return buf->face_type.data();
}
const float* metok_get_verts(void* h, int* n) {
    auto* buf = static_cast<MetokBuffers*>(h);
    *n = (int)(buf->verts.size() / 3);
    return buf->verts.data();
}
const int* metok_get_faces(void* h, int* n) {
    auto* buf = static_cast<MetokBuffers*>(h);
    *n = (int)(buf->faces.size() / 3);
    return buf->faces.data();
}
void metok_free(void* h) { delete static_cast<MetokBuffers*>(h); }

// QEM decimation to ~target_faces; returns buffers with verts + faces
void* metok_decimate(const float* verts, int nv, const int* faces, int nf,
                     int target_faces) {
    metok::Decimator dec(verts, nv, faces, nf);
    dec.decimate_to(target_faces);
    auto* buf = new MetokBuffers();
    dec.extract(buf->verts, buf->faces);
    return buf;
}

}  // extern "C"
