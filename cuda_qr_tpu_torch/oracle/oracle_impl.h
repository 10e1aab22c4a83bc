/* Template body for the MMQR sliding-panel QR oracle.
 *
 * Included twice from qr_oracle.c with SCALAR/SUFFIX defined (double/float).
 * This is an independent C99 implementation of the algorithm specified by
 * the reference's CPU path (qr.c:55-313 -- see SURVEY.md Appendix A for the
 * extracted conventions), serving as the bit-level numerical oracle for the
 * blocked factorizations.  It is NOT a copy: panel dims are runtime parameters, the
 * four-way vstart/vend case split is one function, the W/trailing updates
 * use GEMV forms, and misaligned sizes return an error instead of silently
 * corrupting memory (the reference's verified failure mode, SURVEY.md S4).
 *
 * Algorithm per column panel (width pc_w), sliding row panels bottom-to-top
 * with pc_w rows of overlap (step pr_h - pc_w):
 *   per column j of the panel: Householder reflector over [vstart, vend)
 *     with sign = x0<0 ? -1 : +1, u = x0 + sign*||x||, tau = sign*u/||x||,
 *     stored diag = -sign*||x||, tail = x/u (v0 == 1 implicit);
 *   compact-WY accumulation z = -tau*v - tau*W*(Y^T v), W = [W z];
 *   trailing update A <- (I + Y W^T) A on the panel's rows.
 */

#define CONCAT2(a, b) a##b
#define CONCAT(a, b) CONCAT2(a, b)
#define FN(name) CONCAT(name, SUFFIX)

/* Reflector extent for panel column `col` (panel-local half-open rows).
 * Deduplicates the reference's four-case logic (qr.c:108-141 and 3 copies). */
static void FN(extent_)(int pr_start, int col, int pcol, int pr_h, int pc_w,
                        int m, int* vstart, int* vend) {
  int bottom = (pr_start == m - pr_h);
  int top = (pr_start <= pcol);
  *vstart = top ? (pcol - pr_start + col) : col;
  *vend = bottom ? pr_h : (pr_h - pc_w + col + 1);
}

/* In-place sliding-panel QR.  A is col-major m x n; tau has room for
 * row_panels * col_panels * pc_w entries (layout
 * tau[(row_panels*pci + pri)*pc_w + col], matching qr.cu:517).
 * Returns 0 on success, -1 on misaligned/invalid sizes. */
int FN(mmqr_)(SCALAR* A, SCALAR* tau, int m, int n, int pr_h, int pc_w) {
  if (pc_w >= pr_h || n > m || m < pr_h) return -1;
  if (n % pc_w != 0) return -1;
  if (m != pr_h && (m - pr_h) % (pr_h - pc_w) != 0) return -1;

  int row_panels = (m > pr_h) ? 1 + (m - pr_h + pr_h - pc_w - 1) / (pr_h - pc_w) : 1;
  SCALAR* panel = malloc((size_t)pr_h * pc_w * sizeof(SCALAR));
  SCALAR* W = malloc((size_t)pr_h * pc_w * sizeof(SCALAR));
  SCALAR* Y = malloc((size_t)pr_h * pc_w * sizeof(SCALAR));
  SCALAR* yv = malloc((size_t)pc_w * sizeof(SCALAR));
  SCALAR* ptau = malloc((size_t)pc_w * sizeof(SCALAR));
  if (!panel || !W || !Y || !yv || !ptau) {
    /* free whatever did allocate: the ctypes caller's process stays alive */
    free(panel); free(W); free(Y); free(yv); free(ptau);
    return -2;
  }

  int pci = 0;
  for (int pcol = 0; pcol < n; pcol += pc_w, pci++) {
    int pri = 0;
    for (int pr = m - pr_h; pr + pr_h > pcol && pr >= 0; pr -= pr_h - pc_w, pri++) {
      /* stage panel */
      for (int c = 0; c < pc_w; c++)
        for (int r = 0; r < pr_h; r++)
          panel[c * pr_h + r] = A[(pr + r) + (size_t)(pcol + c) * m];
      memset(W, 0, (size_t)pr_h * pc_w * sizeof(SCALAR));
      memset(Y, 0, (size_t)pr_h * pc_w * sizeof(SCALAR));

      for (int col = 0; col < pc_w; col++) {
        int vstart, vend;
        FN(extent_)(pr, col, pcol, pr_h, pc_w, m, &vstart, &vend);
        SCALAR* pcolv = panel + (size_t)col * pr_h;

        /* Householder generation with max-abs scaling (overflow guard the
         * reference lacks) and zero-column guard (tau = 0 => H = I). */
        SCALAR amax = 0;
        for (int r = vstart; r < vend; r++) {
          SCALAR a = FN(fabs_)(pcolv[r]);
          if (a > amax) amax = a;
        }
        SCALAR t = 0, norm = 0, x0 = pcolv[vstart];
        if (amax > 0) {
          SCALAR ss = 0;
          for (int r = vstart; r < vend; r++) {
            SCALAR a = pcolv[r] / amax;
            ss += a * a;
          }
          norm = amax * FN(sqrt_)(ss);
        }
        SCALAR sign = (x0 < 0) ? (SCALAR)-1 : (SCALAR)1;
        SCALAR u = x0 + sign * norm;
        if (norm > 0) {
          t = sign * u / norm;
          pcolv[vstart] = -sign * norm;
          for (int r = vstart + 1; r < vend; r++) pcolv[r] /= u;
        }
        ptau[col] = t;

        /* Y column = reflector (v0 = 1 implicit in packed storage). */
        Y[(size_t)col * pr_h + vstart] = 1;
        for (int r = vstart + 1; r < vend; r++)
          Y[(size_t)col * pr_h + r] = pcolv[r];

        /* W column: z = -tau*v - tau*W*(Y^T v). */
        for (int k = 0; k < col; k++) {
          SCALAR s = 0;
          for (int r = vstart; r < vend; r++)
            s += Y[(size_t)k * pr_h + r] * Y[(size_t)col * pr_h + r];
          yv[k] = s;
        }
        for (int r = 0; r < pr_h; r++) {
          SCALAR z = -t * Y[(size_t)col * pr_h + r];
          SCALAR wyv = 0;
          for (int k = 0; k < col; k++) wyv += W[(size_t)k * pr_h + r] * yv[k];
          W[(size_t)col * pr_h + r] = z - t * wyv;
        }

        /* Apply H to the remaining panel columns. */
        for (int ac = col + 1; ac < pc_w; ac++) {
          SCALAR* acol = panel + (size_t)ac * pr_h;
          SCALAR dot = 0;
          for (int r = vstart; r < vend; r++)
            dot += Y[(size_t)col * pr_h + r] * acol[r];
          SCALAR td = t * dot;
          for (int r = vstart; r < vend; r++)
            acol[r] -= td * Y[(size_t)col * pr_h + r];
        }
      }

      /* write back packed panel */
      for (int c = 0; c < pc_w; c++)
        for (int r = 0; r < pr_h; r++)
          A[(pr + r) + (size_t)(pcol + c) * m] = panel[c * pr_h + r];

      /* trailing update A <- (I + Y W^T) A on this panel's rows */
      for (int ac = pcol + pc_w; ac < n; ac++) {
        SCALAR* acol = A + (size_t)ac * m + pr;
        for (int k = 0; k < pc_w; k++) {
          SCALAR s = 0;
          for (int r = 0; r < pr_h; r++) s += W[(size_t)k * pr_h + r] * acol[r];
          yv[k] = s;
        }
        for (int r = 0; r < pr_h; r++) {
          SCALAR s = 0;
          for (int k = 0; k < pc_w; k++) s += Y[(size_t)k * pr_h + r] * yv[k];
          acol[r] += s;
        }
      }

      for (int c = 0; c < pc_w; c++)
        tau[((size_t)row_panels * pci + pri) * pc_w + c] = ptau[c];
    }
  }
  free(panel); free(W); free(Y); free(yv); free(ptau);
  return 0;
}

/* Explicit Q (m x m) and R (m x n) from packed factors, applying reflectors
 * in factorization order as rank-1 updates Q <- Q - tau (Q v) v^T --
 * O(m^2) per reflector vs the reference's O(m^3) dense-H product
 * (qr.c:415-429), same math. */
int FN(explicit_qr_)(const SCALAR* A, const SCALAR* tau, SCALAR* Q, SCALAR* R,
                     int m, int n, int pr_h, int pc_w) {
  int row_panels = (m > pr_h) ? 1 + (m - pr_h + pr_h - pc_w - 1) / (pr_h - pc_w) : 1;
  for (int c = 0; c < n; c++)
    for (int r = 0; r < m; r++)
      R[(size_t)c * m + r] = (r <= c) ? A[(size_t)c * m + r] : 0;
  for (int c = 0; c < m; c++)
    for (int r = 0; r < m; r++)
      Q[(size_t)c * m + r] = (r == c) ? 1 : 0;

  SCALAR* v = malloc((size_t)m * sizeof(SCALAR));
  SCALAR* qv = malloc((size_t)m * sizeof(SCALAR));
  if (!v || !qv) { free(v); free(qv); return -2; }

  int pci = 0;
  for (int pcol = 0; pcol < n; pcol += pc_w, pci++) {
    int pri = 0;
    for (int pr = m - pr_h; pr + pr_h > pcol && pr >= 0; pr -= pr_h - pc_w, pri++) {
      for (int col = 0; col < pc_w && pcol + col < n; col++) {
        SCALAR t = tau[((size_t)row_panels * pci + pri) * pc_w + col];
        int vstart, vend;
        FN(extent_)(pr, col, pcol, pr_h, pc_w, m, &vstart, &vend);
        for (int r = 0; r < m; r++) {
          if (r < pr + vstart || r >= pr + vend) v[r] = 0;
          else if (r == pr + vstart) v[r] = 1;
          else v[r] = A[(size_t)(pcol + col) * m + r];
        }
        /* Q <- Q (I - tau v v^T) = Q - tau (Q v) v^T */
        for (int r = 0; r < m; r++) {
          SCALAR s = 0;
          for (int k = pr + vstart; k < pr + vend; k++)
            s += Q[(size_t)k * m + r] * v[k];
          qv[r] = s;
        }
        for (int c = pr + vstart; c < pr + vend; c++) {
          SCALAR tv = t * v[c];
          for (int r = 0; r < m; r++) Q[(size_t)c * m + r] -= qv[r] * tv;
        }
      }
    }
  }
  free(v); free(qv);
  return 0;
}

/* ||Q R - Aorig||_F / ||Aorig||_F and ||Q^T Q - I||_F for verification. */
void FN(qr_check_)(const SCALAR* Aorig, const SCALAR* Q, const SCALAR* R,
                   int m, int n, double* resid, double* orth) {
  double num = 0, den = 0;
  for (int c = 0; c < n; c++) {
    for (int r = 0; r < m; r++) {
      double s = 0;
      for (int k = 0; k <= (c < m ? c : m - 1); k++)
        s += (double)Q[(size_t)k * m + r] * (double)R[(size_t)c * m + k];
      double d = s - (double)Aorig[(size_t)c * m + r];
      num += d * d;
      den += (double)Aorig[(size_t)c * m + r] * (double)Aorig[(size_t)c * m + r];
    }
  }
  *resid = den > 0 ? sqrt(num / den) : sqrt(num);
  double o = 0;
  for (int c = 0; c < m; c++) {
    for (int r = 0; r <= c; r++) {
      double s = 0;
      for (int k = 0; k < m; k++)
        s += (double)Q[(size_t)c * m + k] * (double)Q[(size_t)r * m + k];
      if (r == c) s -= 1.0;
      o += s * s * (r == c ? 1 : 2);
    }
  }
  *orth = sqrt(o);
}

#undef FN
#undef CONCAT
#undef CONCAT2
