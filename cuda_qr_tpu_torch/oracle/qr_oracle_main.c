/* Standalone oracle harness: factor a random matrix, verify, time.
 *
 * The native analog of the reference's benchmark mains (qr.c:461-523,
 * qr.cu:709-857), with verification always on (the reference ships it
 * commented out, qr.cu:822-850) and structured one-line output.
 *
 *   ./qr_oracle_main m n pr pc [trials]
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/time.h>

int mmqr_d(double*, double*, int, int, int, int);
int explicit_qr_d(const double*, const double*, double*, double*, int, int, int, int);
void qr_check_d(const double*, const double*, const double*, int, int, double*, double*);
void panel_dims(int, int, int, int, int*, int*);

static double now_s(void) {
  struct timeval tv;
  gettimeofday(&tv, 0);
  return tv.tv_sec + 1e-6 * tv.tv_usec;
}

int main(int argc, char** argv) {
  int m = 6, n = 4, pr = 4, pc = 2, trials = 3;
  if (argc >= 5) { m = atoi(argv[1]); n = atoi(argv[2]); pr = atoi(argv[3]); pc = atoi(argv[4]); }
  if (argc >= 6) trials = atoi(argv[5]);
  int rp, cp;
  panel_dims(m, n, pr, pc, &rp, &cp);
  double* A = malloc((size_t)m * n * sizeof(double));
  double* RV = malloc((size_t)m * n * sizeof(double));
  double* tau = calloc((size_t)rp * cp * pc, sizeof(double));
  srand(12); /* the reference's fixed seed (qr.cu:765) for reproducibility */
  for (size_t i = 0; i < (size_t)m * n; i++) A[i] = (double)rand() / RAND_MAX;

  double best = 1e30;
  int rc = 0;
  for (int t = 0; t < trials; t++) {
    memcpy(RV, A, (size_t)m * n * sizeof(double));
    double t0 = now_s();
    rc = mmqr_d(RV, tau, m, n, pr, pc);
    double dt = now_s() - t0;
    if (dt < best) best = dt;
    if (rc) { fprintf(stderr, "mmqr_d failed: %d\n", rc); return 1; }
  }
  double* Q = malloc((size_t)m * m * sizeof(double));
  double* R = malloc((size_t)m * n * sizeof(double));
  explicit_qr_d(RV, tau, Q, R, m, n, pr, pc);
  double resid, orth;
  qr_check_d(A, Q, R, m, n, &resid, &orth);
  double flops = 2.0 * m * (double)n * n - 2.0 / 3.0 * (double)n * n * n;
  printf("{\"m\": %d, \"n\": %d, \"pr\": %d, \"pc\": %d, \"time_s\": %.6f, "
         "\"gflops\": %.4f, \"residual\": %.3e, \"orthogonality\": %.3e}\n",
         m, n, pr, pc, best, flops / best / 1e9, resid, orth);
  return resid < 1e-13 * n ? 0 : 2;
}
