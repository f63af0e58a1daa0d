// The argkmin tile and merge kernels with 8-entry lists (TK <= 8), for every
// D; see argkmin.cu.

#include "argkmin.cuh"

extern "C" int argkmin_lists_tkb8(REPRO_ARGKMIN_LISTS_ARGS) {
  return repro_argkmin::argkmin_lists<8>(store, valid, batch, bvalid, val, idx, pval, pidx,
                                          pcol, c, d, m, tk, splits, base_id, row0,
                                          stream);
}

extern "C" int argkmin_resident_tkb8(int d) {
  return repro_argkmin::resident_blocks_for<8>(d);
}
