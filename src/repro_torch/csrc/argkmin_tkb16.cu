// The argkmin tile and merge kernels with 16-entry lists (TK <= 16), for every
// D; see argkmin.cu.

#include "argkmin.cuh"

extern "C" int argkmin_lists_tkb16(REPRO_ARGKMIN_LISTS_ARGS) {
  return repro_argkmin::argkmin_lists<16>(store, valid, batch, bvalid, val, idx, pval, pidx,
                                          pcol, c, d, m, tk, splits, base_id, row0,
                                          stream);
}

extern "C" int argkmin_resident_tkb16(int d) {
  return repro_argkmin::resident_blocks_for<16>(d);
}
