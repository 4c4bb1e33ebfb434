// pynama_tpu: C++ mesh/graph kernel.
//
// Native replacement for the graph-building work the reference delegates to
// the PETSc C library (DMPlex connectivity/closure: reference
// src/domain/dmplex.py:193-372 drives DMPlex's C mesh machinery;
// src/domain/indices.py maps entities to spectral node ids). The hot
// setup-time loops — unique-edge extraction, per-cell high-order node
// assembly with orientation-consistent edge traversal, and node->element
// fan-in (incidence) construction — run here in C++; Python keeps a numpy
// fallback with identical semantics (pynama_tpu/mesh/unstructured.py).
//
// Also: a background double-buffered raw-binary snapshot writer (the async
// analog of PETSc's Viewer write path) — see pn_writer_*.
//
// C ABI only (consumed through ctypes). All arrays are caller-allocated.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <deque>
#include <string>

extern "C" {

// ---------------------------------------------------------------- edges
// cells_tensor: (C,4) int32 tensor-order corners [c00, c01, c10, c11].
// Emits unique edges as sorted (lo,hi) vertex pairs and the per-cell edge
// ids in slot order [row0, row1, col0, col1] (matching
// UnstructuredMesh._edge_table).
// out_edges must have room for 4*C pairs. Returns n_edges.
int64_t pn_unique_edges(const int32_t* cells, int64_t C,
                        int32_t* out_edges, int32_t* cell_edges) {
    // slot -> (corner a, corner b) in tensor order
    static const int slot[4][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}};
    std::unordered_map<uint64_t, int32_t> seen;
    seen.reserve(static_cast<size_t>(4 * C));
    int64_t ne = 0;
    for (int64_t c = 0; c < C; ++c) {
        const int32_t* q = cells + 4 * c;
        for (int s = 0; s < 4; ++s) {
            int32_t u = q[slot[s][0]], v = q[slot[s][1]];
            int32_t lo = u < v ? u : v, hi = u < v ? v : u;
            uint64_t key = (static_cast<uint64_t>(lo) << 32)
                           | static_cast<uint32_t>(hi);
            auto it = seen.find(key);
            int32_t id;
            if (it == seen.end()) {
                id = static_cast<int32_t>(ne);
                seen.emplace(key, id);
                out_edges[2 * ne] = lo;
                out_edges[2 * ne + 1] = hi;
                ++ne;
            } else {
                id = it->second;
            }
            cell_edges[4 * c + s] = id;
        }
    }
    // canonical edge order: the Python fallback (np.unique) sorts edges
    // lexicographically; reproduce that so both paths number identically.
    std::vector<int64_t> order(ne);
    for (int64_t i = 0; i < ne; ++i) order[i] = i;
    std::vector<int64_t> rank(ne);
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        if (out_edges[2 * a] != out_edges[2 * b])
            return out_edges[2 * a] < out_edges[2 * b];
        return out_edges[2 * a + 1] < out_edges[2 * b + 1];
    });
    std::vector<int32_t> sorted_edges(2 * ne);
    for (int64_t r = 0; r < ne; ++r) {
        rank[order[r]] = r;
        sorted_edges[2 * r] = out_edges[2 * order[r]];
        sorted_edges[2 * r + 1] = out_edges[2 * order[r] + 1];
    }
    std::memcpy(out_edges, sorted_edges.data(),
                sizeof(int32_t) * 2 * ne);
    for (int64_t c = 0; c < 4 * C; ++c)
        cell_edges[c] = static_cast<int32_t>(rank[cell_edges[c]]);
    return ne;
}

// ------------------------------------------------------------ cell nodes
// Global high-order node table per cell, tensor order (a0 slowest).
// Numbering: vertices [0,V), edge nodes V + e*(N-2) + k stored
// low-vertex -> high-vertex, interiors V + E*(N-2) + c*(N-2)^2 + i.
void pn_cell_nodes(const int32_t* cells, const int32_t* cell_edges,
                   int64_t C, int64_t V, int64_t E, int32_t N,
                   int32_t* out /* (C, N*N) */) {
    const int32_t k = N - 2;
    static const int slot_corner[4][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}};
    const int64_t int_base = V + E * k;
    for (int64_t c = 0; c < C; ++c) {
        const int32_t* q = cells + 4 * c;
        int32_t* o = out + static_cast<int64_t>(N) * N * c;
        o[0] = q[0];
        o[N - 1] = q[1];
        o[static_cast<int64_t>(N - 1) * N] = q[2];
        o[static_cast<int64_t>(N - 1) * N + (N - 1)] = q[3];
        if (k <= 0) continue;
        for (int s = 0; s < 4; ++s) {
            const int32_t e = cell_edges[4 * c + s];
            const bool rev = q[slot_corner[s][0]] > q[slot_corner[s][1]];
            const int64_t base = V + static_cast<int64_t>(e) * k;
            for (int32_t j = 0; j < k; ++j) {
                const int64_t nid = rev ? base + (k - 1 - j) : base + j;
                int64_t a0, a1;
                switch (s) {
                    case 0: a0 = 0;      a1 = j + 1;  break;  // row a0=0
                    case 1: a0 = N - 1;  a1 = j + 1;  break;  // row a0=N-1
                    case 2: a0 = j + 1;  a1 = 0;      break;  // col a1=0
                    default: a0 = j + 1; a1 = N - 1;  break;  // col a1=N-1
                }
                o[a0 * N + a1] = static_cast<int32_t>(nid);
            }
        }
        const int64_t ib = int_base + static_cast<int64_t>(c) * k * k;
        for (int32_t i = 0; i < k; ++i)
            for (int32_t j = 0; j < k; ++j)
                o[static_cast<int64_t>(i + 1) * N + (j + 1)] =
                    static_cast<int32_t>(ib + i * k + j);
    }
}

// ------------------------------------------------------------- incidence
// Pass 1: max fan-in over nodes. Pass 2 fills the padded table.
int64_t pn_incidence_kmax(const int32_t* cell_nodes, int64_t total,
                          int64_t n_nodes) {
    std::vector<int64_t> counts(n_nodes, 0);
    for (int64_t i = 0; i < total; ++i) counts[cell_nodes[i]]++;
    int64_t kmax = 0;
    for (int64_t n = 0; n < n_nodes; ++n)
        if (counts[n] > kmax) kmax = counts[n];
    return kmax;
}

void pn_incidence_fill(const int32_t* cell_nodes, int64_t total,
                       int64_t n_nodes, int64_t kmax,
                       int32_t* out /* (n_nodes, kmax) */) {
    std::vector<int64_t> cursor(n_nodes, 0);
    for (int64_t i = 0; i < static_cast<int64_t>(n_nodes) * kmax; ++i)
        out[i] = static_cast<int32_t>(total);   // pad slot
    for (int64_t i = 0; i < total; ++i) {
        const int32_t n = cell_nodes[i];
        out[static_cast<int64_t>(n) * kmax + cursor[n]++] =
            static_cast<int32_t>(i);
    }
}

// --------------------------------------------------- async binary writer
// Double-buffered background writer: pn_writer_submit copies the payload
// into an owned buffer and returns immediately; a worker thread drains the
// queue to disk. The compute path never blocks on file IO (the async
// analog of the reference's per-step PETSc HDF5 dumps,
// src/viewer/paraviewer.py:40-66).

struct Writer {
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv;
    std::deque<std::pair<std::string, std::vector<char>>> queue;
    bool stop = false;
    bool in_flight = false;  // job popped but not yet fully on disk
    int64_t max_queue = 4;

    void run() {
        for (;;) {
            std::pair<std::string, std::vector<char>> job;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] { return stop || !queue.empty(); });
                if (queue.empty()) {
                    if (stop) return;
                    continue;
                }
                job = std::move(queue.front());
                queue.pop_front();
                in_flight = true;
            }
            FILE* f = std::fopen(job.first.c_str(), "wb");
            if (f) {
                std::fwrite(job.second.data(), 1, job.second.size(), f);
                std::fclose(f);
            }
            {
                std::unique_lock<std::mutex> lk(mu);
                in_flight = false;
            }
            cv.notify_all();
        }
    }
};

void* pn_writer_create(int64_t max_queue) {
    Writer* w = new Writer();
    if (max_queue > 0) w->max_queue = max_queue;
    w->worker = std::thread([w] { w->run(); });
    return w;
}

// Blocks only when the queue is full (backpressure), never on the write.
void pn_writer_submit(void* handle, const char* path,
                      const void* data, int64_t nbytes) {
    Writer* w = static_cast<Writer*>(handle);
    std::vector<char> buf(static_cast<size_t>(nbytes));
    std::memcpy(buf.data(), data, static_cast<size_t>(nbytes));
    {
        std::unique_lock<std::mutex> lk(w->mu);
        w->cv.wait(lk, [&] {
            return static_cast<int64_t>(w->queue.size()) < w->max_queue;
        });
        w->queue.emplace_back(std::string(path), std::move(buf));
    }
    w->cv.notify_all();
}

void pn_writer_flush(void* handle) {
    Writer* w = static_cast<Writer*>(handle);
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv.wait(lk, [&] { return w->queue.empty() && !w->in_flight; });
}

void pn_writer_destroy(void* handle) {
    Writer* w = static_cast<Writer*>(handle);
    {
        std::unique_lock<std::mutex> lk(w->mu);
        w->stop = true;
    }
    w->cv.notify_all();
    w->worker.join();
    delete w;
}

}  // extern "C"
