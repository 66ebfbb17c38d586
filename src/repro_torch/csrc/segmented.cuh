// K8: flag-array segmented prefix scan of flat (n,) leaves, inclusive or
// exclusive, under segmented(op) for any associative op (commutative or
// not).  A template over the generated functor of the lifted operator, whose
// element is (int32 flag, value leaves...).
//
// Replaces: src/repro/kernels/segmented.py::segmented_scan_1d_pallas (body
// _segscan1d_kernel), which walks the stream on the TPU's sequential grid
// with a lifted (flag, value) carry in VMEM.
//
// Bound on this card: memory.  The least traffic is one read and one write
// of every value element and one read of every flag: at n = 10^8 f32,
// 1.2 GB, 0.358 ms at 3.35 TB/s.  Design: K2's three-phase tile scan
// (tile_scan.cuh: reduce, scan of the tile totals, rescan) instantiated over
// the lifted element.  The flags ride as leaf 0 of the loaded element and
// are never written back (the output leaves start at 1).  The carry of the
// lifted operator resets by itself where a boundary flowed past; an
// exclusive scan gives the inner identity at every segment start, as the
// reference's ops.py does.  Values are read twice, so expect about 1.5x the
// bound, as K2 shows.
#pragma once

#include "tile_scan.cuh"

namespace rt {
namespace segmented {
namespace {

// x = {flags, values...}, y = {null, outputs...}.  `scratch` holds
// cdiv(n, tile) lifted elements when n > tile.
// N: the tile's knob (tile_scan.cuh: Tile).
template <typename Op, int N = 8>
cudaError_t scan(Leaves x, Leaves y, long n, bool inclusive, void* scratch,
                 cudaStream_t stream) {
  if (n <= 0 || y.p[0] != nullptr) return cudaErrorInvalidValue;
  return tile::launch_scan_rows<Op, true, N>(x, y, 1, n, inclusive, scratch,
                                             stream);
}

}  // namespace
}  // namespace segmented
}  // namespace rt
