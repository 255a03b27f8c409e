// Native greedy next-fit sequence packer of the port: the host-side hot
// stage of the packed serving feed. A copy of svoc_tpu/runtime/packer.cpp
// (svoc_pack_tokens, line 19), changed in nothing but this comment; built
// and bound by svoc_torch/runtime/native.py. Its semantics are those of
// svoc_torch/models/packing.py::pack_tokens, exactly (held against it in
// tests/test_torch_runtime.py).
//
// Input is the flattened concatenation of per-comment token lists with
// prefix offsets (list i = flat[offsets[i] .. offsets[i+1])).  Output
// arrays are caller-allocated [rows_cap, seq_len] / [rows_cap,
// max_segments] and must be PRE-FILLED by the caller (ids/pos = pad_id,
// seg/cls_pos/seg_valid = 0, owner = -1) — the packer only writes the
// cells it fills, exactly like the numpy reference.
//
// out[0] = rows actually used, out[1] = comments consumed (when
// rows_cap bounds the packing, unconsumed comments stay for the next
// call — the streaming resume contract).

#include <cstdint>

extern "C" void svoc_pack_tokens(
    const int32_t* flat,
    const int64_t* offsets,
    int n_lists,
    int seq_len,
    int max_segments,
    int32_t pad_id,
    int rows_cap,
    int32_t* ids,
    int32_t* pos,
    int32_t* seg,
    int32_t* cls_pos,
    int32_t* seg_valid,
    int32_t* owner,
    int32_t* out) {
  if (rows_cap < 1) {  // defensive: the ctypes wrapper validates too
    out[0] = 0;
    out[1] = 0;
    return;
  }
  int row = 0;
  int cur_len = 0;
  int cur_seg = 0;
  int consumed = 0;
  for (int i = 0; i < n_lists; ++i) {
    int64_t begin = offsets[i];
    int len = static_cast<int>(offsets[i + 1] - begin);
    if (len > seq_len) len = seq_len;  // truncate (== toks[:seq_len])
    const bool empty = (len == 0);     // degenerate: still owns a segment
    const int eff = empty ? 1 : len;
    if (cur_len + eff > seq_len || cur_seg >= max_segments) {
      // flush (the condition can only trigger with a non-empty row,
      // since a single truncated list always fits an empty one)
      ++row;
      cur_len = 0;
      cur_seg = 0;
      if (row >= rows_cap) break;  // row budget: do NOT consume list i
    }
    const int64_t base = static_cast<int64_t>(row) * seq_len;
    if (empty) {
      ids[base + cur_len] = pad_id;
    } else {
      const int32_t* src = flat + begin;
      for (int j = 0; j < len; ++j) ids[base + cur_len + j] = src[j];
    }
    for (int j = 0; j < eff; ++j) {
      pos[base + cur_len + j] = pad_id + 1 + j;  // restart per segment
      seg[base + cur_len + j] = cur_seg + 1;     // 1-based, 0 = padding
    }
    const int64_t sbase = static_cast<int64_t>(row) * max_segments;
    cls_pos[sbase + cur_seg] = cur_len;
    seg_valid[sbase + cur_seg] = 1;
    owner[sbase + cur_seg] = i;
    cur_len += eff;
    ++cur_seg;
    ++consumed;
  }
  out[0] = row + (cur_seg > 0 ? 1 : 0);
  out[1] = consumed;
}
