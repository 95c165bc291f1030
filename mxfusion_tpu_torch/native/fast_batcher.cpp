// Native minibatch gather and shuffle for the host-side data pipeline.
//
// A copy of mxfusion_tpu/native/fast_batcher.cpp, kept in the port so
// that it never imports the JAX package: gathering a shuffled batch of
// rows from a large training array into a contiguous staging buffer
// before the host-to-device copy, and the epoch's Fisher-Yates
// permutation, whose splitmix64 stream both packages share (the same
// seed gives the same batches in either). Exposed through ctypes;
// numpy is the fallback.
//
// Build: c++ -O3 -shared -fPIC -std=c++17 -o libfastbatcher.so
//        fast_batcher.cpp -lpthread   (done lazily by loader.py)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// Gather rows: dst[i, :] = src[idx[i], :] for i in [0, n_idx).
// row_bytes is the byte size of one row; parallelized over rows.
void gather_rows(const char* src, const int64_t* idx, char* dst,
                 int64_t n_idx, int64_t row_bytes, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    int hw = (int)std::thread::hardware_concurrency();
    if (hw > 0) n_threads = std::min(n_threads, hw);
    n_threads = (int)std::min<int64_t>(n_threads, n_idx > 0 ? n_idx : 1);

    auto worker = [&](int64_t start, int64_t end) {
        for (int64_t i = start; i < end; ++i) {
            std::memcpy(dst + i * row_bytes,
                        src + idx[i] * row_bytes,
                        (size_t)row_bytes);
        }
    };
    if (n_threads == 1 || n_idx < 1024) {
        worker(0, n_idx);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n_idx + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t s = t * chunk;
        int64_t e = std::min(n_idx, s + chunk);
        if (s >= e) break;
        threads.emplace_back(worker, s, e);
    }
    for (auto& th : threads) th.join();
}

// Fisher-Yates shuffle of [0..n) with a splitmix64 PRNG; fills idx.
void shuffled_indices(int64_t* idx, int64_t n, uint64_t seed) {
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    uint64_t x = seed + 0x9E3779B97F4A7C15ull;
    auto next = [&x]() {
        x += 0x9E3779B97F4A7C15ull;
        uint64_t z = x;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    };
    for (int64_t i = n - 1; i > 0; --i) {
        int64_t j = (int64_t)(next() % (uint64_t)(i + 1));
        std::swap(idx[i], idx[j]);
    }
}

}  // extern "C"
