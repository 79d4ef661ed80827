// arecio — native host-side batch assembly for arec_torch (a copy of
// arec/native/packer.cpp with the same C ABI).
//
// The reference's training hot loop spent host time assembling feed_dict
// batches in Python (SURVEY.md §3.1 "host-side negative sampling + feed_dict
// assembly ... a real bottleneck"). The rebuild moved negative sampling on
// device; what remains on the host is sequence packing (truncate to L,
// left-pad, build inputs/targets/mask) and eval-history packing — Python
// loops over batch rows. This library does that packing at memcpy speed.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All arrays are caller-allocated int32/float32, C-contiguous.
//
// Build: arec_torch/native/build.py (g++ -O3 -shared -fPIC, at first use).

#include <cstdint>
#include <cstring>

extern "C" {

// Pack next-item-prediction training batches.
//   hist        [num_users, max_hist] int32, PAD = -1, newest last
//   hist_len    [num_users] int32
//   users       [batch] int32 — row selection
//   L           max_seq_len
// Outputs (caller-allocated):
//   inputs      [batch, L] int32  (pad id = pad_item)
//   targets     [batch, L] int32
//   mask        [batch, L] float32
// For each row: take the most recent min(len, L+1) items h, emit
// inputs = h[:-1], targets = h[1:], left-padded.
void arec_pack_train_sequences(
    const int32_t* hist, const int32_t* hist_len,
    int64_t max_hist,
    const int32_t* users, int64_t batch,
    int64_t L, int32_t pad_item,
    int32_t* inputs, int32_t* targets, float* mask) {
  for (int64_t r = 0; r < batch; ++r) {
    const int64_t u = users[r];
    const int32_t* h = hist + u * max_hist;
    int64_t len = hist_len[u];
    if (len > L + 1) {
      h += len - (L + 1);
      len = L + 1;
    }
    const int64_t t = len > 0 ? len - 1 : 0;   // emitted positions
    const int64_t off = L - t;
    int32_t* in_row = inputs + r * L;
    int32_t* tg_row = targets + r * L;
    float* mk_row = mask + r * L;
    for (int64_t i = 0; i < off; ++i) {
      in_row[i] = pad_item;
      tg_row[i] = pad_item;
      mk_row[i] = 0.0f;
    }
    for (int64_t i = 0; i < t; ++i) {
      in_row[off + i] = h[i];
      tg_row[off + i] = h[i + 1];
      mk_row[off + i] = 1.0f;
    }
  }
}

// Pack full histories for the recommend/eval path: inputs = last min(len, L)
// items, left-padded; mask marks real positions.
void arec_pack_eval_sequences(
    const int32_t* hist, const int32_t* hist_len,
    int64_t max_hist,
    const int32_t* users, int64_t batch,
    int64_t L, int32_t pad_item,
    int32_t* inputs, float* mask) {
  for (int64_t r = 0; r < batch; ++r) {
    const int64_t u = users[r];
    const int32_t* h = hist + u * max_hist;
    int64_t len = hist_len[u];
    if (len > L) {
      h += len - L;
      len = L;
    }
    const int64_t off = L - len;
    int32_t* in_row = inputs + r * L;
    float* mk_row = mask + r * L;
    for (int64_t i = 0; i < off; ++i) {
      in_row[i] = pad_item;
      mk_row[i] = 0.0f;
    }
    for (int64_t i = 0; i < len; ++i) {
      in_row[off + i] = h[i];
      mk_row[off + i] = 1.0f;
    }
  }
}

// Gather rows: out[r] = src[idx[r]] for int32 matrices — the fancy-index
// used all over batch assembly, without numpy temp allocations.
void arec_gather_rows_i32(
    const int32_t* src, int64_t width,
    const int64_t* idx, int64_t n,
    int32_t* out) {
  for (int64_t r = 0; r < n; ++r) {
    std::memcpy(out + r * width, src + idx[r] * width,
                sizeof(int32_t) * width);
  }
}

int32_t arec_abi_version() { return 1; }

}  // extern "C"
