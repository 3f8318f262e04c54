// The batch gather of brainmagick_tpu_torch's loader: fixed-shape epoch
// batches assembled from a recording's preprocessed [C, T_total] memmap,
// and windows of a feature track.
//
// One batch at the paper's shape (256 x 208 sensors x 361 samples) is
// 256 x 208 short rows (1.4 KB each) read from rows of a whole recording,
// each less its mean over the baseline window (mne.Epochs' baseline
// correction as the datasets apply it). Worker threads take rows from a
// shared counter and write each output row once.
//
// The *_bf16 entry points write bfloat16 bit patterns (round to nearest
// even, NaN kept quiet) straight into the batch, so that a loader whose
// wire format is bf16 (parallel.assemble_dtype) neither writes nor
// rereads an fp32 batch.
//
// Plain C interface, loaded with ctypes (native/gather.py builds it with
// g++ at first use). Layouts:
//   raw:    [n_channels, total_samples] float32, rows contiguous
//   starts: [batch] int64, each window's first sample
//   out:    [batch, out_channels, n_times] float32 or uint16 (bf16 bits),
//           the rows past n_channels zero
// Every entry point returns 0, or -1 (writing nothing) when a window
// leaves the recording or the sizes disagree.
//
// The baseline mean is summed in double in sample order, divided by the
// window's length, rounded once to float and subtracted in float: the
// plain version in dataset.py (gather_epochs) computes the same bits.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint16_t to_bf16(float value) {
    uint32_t bits;
    std::memcpy(&bits, &value, sizeof(bits));
    if ((bits & 0x7fffffffu) > 0x7f800000u)      // NaN: keep it quiet
        return static_cast<uint16_t>((bits >> 16) | 0x0040u);
    bits += 0x7fffu + ((bits >> 16) & 1u);       // round to nearest even
    return static_cast<uint16_t>(bits >> 16);
}

inline void store(float* dst, float value) { *dst = value; }
inline void store(uint16_t* dst, float value) { *dst = to_bf16(value); }

template <typename Out>
int gather(const float* raw, int64_t n_channels, int64_t total_samples,
           const int64_t* starts, int64_t batch, int64_t n_times,
           int64_t out_channels, int64_t baseline_len, Out* out,
           int n_threads) {
    if (n_channels < 0 || out_channels < n_channels || n_times < 0
            || baseline_len < 0 || baseline_len > n_times)
        return -1;
    for (int64_t b = 0; b < batch; ++b)
        if (starts[b] < 0 || starts[b] + n_times > total_samples) return -1;
    if (n_threads <= 0) {
        n_threads = static_cast<int>(std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 4;
    }

    const int64_t rows = batch * n_channels;
    const int64_t chunk = 8;                     // rows a counter step
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        for (;;) {
            const int64_t first = next.fetch_add(chunk);
            if (first >= rows) return;
            const int64_t last = first + chunk < rows ? first + chunk : rows;
            for (int64_t row = first; row < last; ++row) {
                const int64_t b = row / n_channels, c = row % n_channels;
                const float* src = raw + c * total_samples + starts[b];
                Out* dst = out + (b * out_channels + c) * n_times;
                if (row + 1 < rows) {
                    // the next row lies a whole recording row away: ask
                    // for its first lines now
                    const int64_t b2 = (row + 1) / n_channels;
                    const int64_t c2 = (row + 1) % n_channels;
                    const float* ahead = raw + c2 * total_samples + starts[b2];
                    __builtin_prefetch(ahead, 0, 1);
                    __builtin_prefetch(ahead + 16, 0, 1);
                }
                if (baseline_len > 0) {
                    double sum = 0.0;
                    for (int64_t t = 0; t < baseline_len; ++t) sum += src[t];
                    const float mean = static_cast<float>(
                        sum / static_cast<double>(baseline_len));
                    for (int64_t t = 0; t < n_times; ++t)
                        store(dst + t, src[t] - mean);
                } else if (sizeof(Out) == sizeof(float)) {
                    std::memcpy(dst, src, sizeof(float) * n_times);
                } else {
                    for (int64_t t = 0; t < n_times; ++t)
                        store(dst + t, src[t]);
                }
            }
        }
    };
    std::vector<std::thread> threads;
    for (int k = 1; k < n_threads; ++k) threads.emplace_back(work);
    work();
    for (auto& thread : threads) thread.join();

    if (out_channels > n_channels) {            // the padding rows
        for (int64_t b = 0; b < batch; ++b)
            std::memset(out + (b * out_channels + n_channels) * n_times, 0,
                        sizeof(Out) * (out_channels - n_channels) * n_times);
    }
    return 0;
}

}  // namespace

extern "C" {

// Epochs less their baseline mean (baseline_len samples from each start;
// 0: none), float32.
int gather_epochs(const float* raw, int64_t n_channels,
                  int64_t total_samples, const int64_t* starts,
                  int64_t batch, int64_t n_times, int64_t out_channels,
                  int64_t baseline_len, float* out, int n_threads) {
    return gather<float>(raw, n_channels, total_samples, starts, batch,
                         n_times, out_channels, baseline_len, out,
                         n_threads);
}

// The same, written as bfloat16 bit patterns.
int gather_epochs_bf16(const float* raw, int64_t n_channels,
                       int64_t total_samples, const int64_t* starts,
                       int64_t batch, int64_t n_times,
                       int64_t out_channels, int64_t baseline_len,
                       uint16_t* out, int n_threads) {
    return gather<uint16_t>(raw, n_channels, total_samples, starts, batch,
                            n_times, out_channels, baseline_len, out,
                            n_threads);
}

// Windows [batch, dim, n_times] of a feature track [dim, total_samples].
int gather_track(const float* track, int64_t dim, int64_t total_samples,
                 const int64_t* starts, int64_t batch, int64_t n_times,
                 float* out, int n_threads) {
    return gather<float>(track, dim, total_samples, starts, batch, n_times,
                         dim, 0, out, n_threads);
}

int gather_track_bf16(const float* track, int64_t dim,
                      int64_t total_samples, const int64_t* starts,
                      int64_t batch, int64_t n_times, uint16_t* out,
                      int n_threads) {
    return gather<uint16_t>(track, dim, total_samples, starts, batch,
                            n_times, dim, 0, out, n_threads);
}

}  // extern "C"
