/* Native C99 MMQR oracle: double + float instantiations.
 *
 * The reference keeps its whole CPU path native (qr.c); this library plays
 * the same role for cuda_qr_tpu_torch -- the bit-level semantic specification
 * of the sliding-panel algorithm, run through ctypes from Python tests and
 * from the standalone harness in qr_oracle_main.c.
 *
 * Build: binding.py compiles it with cc at first use (libqroracle.so).
 */

#include <math.h>
#include <stdlib.h>
#include <string.h>

#define SCALAR double
#define SUFFIX d
#define fabs_d fabs
#define sqrt_d sqrt
#include "oracle_impl.h"
#undef SCALAR
#undef SUFFIX

#define SCALAR float
#define SUFFIX s
#define fabs_s fabsf
#define sqrt_s sqrtf
#include "oracle_impl.h"
#undef SCALAR
#undef SUFFIX

/* The template instantiations above already export the flat API:
 * mmqr_d/mmqr_s, explicit_qr_d/explicit_qr_s, qr_check_d/qr_check_s
 * (FN(name) appends the SUFFIX: mmqr_ + d -> mmqr_d). */

/* Panel-grid helpers mirrored for callers (qr.cu:49-55 analog). */
void panel_dims(int m, int n, int pr, int pc, int* row_panels, int* col_panels) {
  *col_panels = (n + pc - 1) / pc;
  *row_panels = (m > pr) ? 1 + (m - pr + pr - pc - 1) / (pr - pc) : 1;
}
