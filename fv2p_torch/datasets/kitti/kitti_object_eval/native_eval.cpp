// Native core of the official KITTI AP evaluation: the greedy gt <-> detection
// matching of the KITTI devkit (the reference runs it as numba-jit loops in
// pcdet/datasets/kitti/kitti_object_eval_python/eval.py), with a plain C
// interface loaded through ctypes by eval.py:
//   * greedy assignment of detections to ground truths, ignoring entries per
//     the difficulty rules; two phases: (1) collect TP scores to derive the
//     41 recall-sample thresholds, (2) accumulate tp/fp/fn (+AOS similarity)
//     per threshold, with don't-care region suppression for the bbox metric.
//
// Build (eval.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 native_eval.cpp -o libnative_eval.so

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr double NO_DETECTION = -10000000.0;

// axis-aligned image-box overlap with selectable denominator criterion
double image_box_overlap_one(const double* a, const double* b, int criterion) {
  double iw = std::min(a[2], b[2]) - std::max(a[0], b[0]);
  if (iw <= 0) return 0.0;
  double ih = std::min(a[3], b[3]) - std::max(a[1], b[1]);
  if (ih <= 0) return 0.0;
  double area_a = (a[2] - a[0]) * (a[3] - a[1]);
  double area_b = (b[2] - b[0]) * (b[3] - b[1]);
  double ua;
  if (criterion == -1) ua = area_a + area_b - iw * ih;
  else if (criterion == 0) ua = area_a;
  else if (criterion == 1) ua = area_b;
  else ua = 1.0;
  return iw * ih / ua;
}

struct Stats {
  long tp = 0, fp = 0, fn = 0;
  double similarity = 0.0;
};

// One pass of the matching for a single image at a given score threshold.
// overlaps is (num_dt, num_gt) row-major (overlap[j * num_gt + i]).
Stats match_one(const double* overlaps, int num_gt, int num_dt,
                const double* gt_datas,   // (gt, 5): bbox(4) + alpha
                const double* dt_datas,   // (dt, 6): bbox(4) + alpha + score
                const int64_t* ignored_gt, const int64_t* ignored_det,
                const double* dc_bboxes, int num_dc, int metric,
                double min_overlap, double thresh, bool compute_fp,
                bool compute_aos, double* thresholds_out, int* n_thresh_out,
                bool* assigned_buf, bool* ignored_thresh_buf,
                double* delta_buf) {
  Stats st;
  int thresh_idx = 0, delta_idx = 0;
  for (int j = 0; j < num_dt; ++j) {
    assigned_buf[j] = false;
    ignored_thresh_buf[j] = compute_fp && (dt_datas[j * 6 + 5] < thresh);
  }

  for (int i = 0; i < num_gt; ++i) {
    if (ignored_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = NO_DETECTION;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;

    for (int j = 0; j < num_dt; ++j) {
      if (ignored_det[j] == -1 || assigned_buf[j] || ignored_thresh_buf[j])
        continue;
      double overlap = overlaps[(size_t)j * num_gt + i];
      double dt_score = dt_datas[j * 6 + 5];
      if (!compute_fp && overlap > min_overlap && dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap
                 && (overlap > max_overlap || assigned_ignored_det)
                 && ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap
                 && valid_detection == NO_DETECTION && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
      st.fn += 1;
    } else if (valid_detection != NO_DETECTION
               && (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned_buf[det_idx] = true;
    } else if (valid_detection != NO_DETECTION) {
      st.tp += 1;
      if (thresholds_out) thresholds_out[thresh_idx] = dt_datas[det_idx * 6 + 5];
      thresh_idx += 1;
      if (compute_aos) {
        delta_buf[delta_idx] = gt_datas[i * 5 + 4] - dt_datas[det_idx * 6 + 4];
        delta_idx += 1;
      }
      assigned_buf[det_idx] = true;
    }
  }

  if (compute_fp) {
    for (int j = 0; j < num_dt; ++j) {
      if (!(assigned_buf[j] || ignored_det[j] == -1 || ignored_det[j] == 1
            || ignored_thresh_buf[j]))
        st.fp += 1;
    }
    long nstuff = 0;
    if (metric == 0) {
      for (int d = 0; d < num_dc; ++d) {
        for (int j = 0; j < num_dt; ++j) {
          if (assigned_buf[j]) continue;
          if (ignored_det[j] == -1 || ignored_det[j] == 1) continue;
          if (ignored_thresh_buf[j]) continue;
          double ov = image_box_overlap_one(&dt_datas[j * 6], &dc_bboxes[d * 4], 0);
          if (ov > min_overlap) {
            assigned_buf[j] = true;
            nstuff += 1;
          }
        }
      }
    }
    st.fp -= nstuff;
    if (compute_aos) {
      if (st.tp > 0 || st.fp > 0) {
        double sim = 0.0;
        for (int i = 0; i < delta_idx; ++i)
          sim += (1.0 + std::cos(delta_buf[i])) / 2.0;
        st.similarity = sim;
      } else {
        st.similarity = -1.0;
      }
    }
  }
  if (n_thresh_out) *n_thresh_out = thresh_idx;
  return st;
}

}  // namespace

extern "C" {

// Phase 1: collect the TP scores of one image (compute_fp = false).
// Returns the number of thresholds written into thresholds_out (size >= num_gt).
int collect_tp_scores(const double* overlaps, int num_gt, int num_dt,
                      const double* gt_datas, const double* dt_datas,
                      const int64_t* ignored_gt, const int64_t* ignored_det,
                      int metric, double min_overlap,
                      double* thresholds_out) {
  bool assigned[4096];
  bool ignored_thr[4096];
  double delta[4096];
  if (num_dt > 4096 || num_gt > 4096) return -1;
  int n_thresh = 0;
  match_one(overlaps, num_gt, num_dt, gt_datas, dt_datas, ignored_gt,
            ignored_det, nullptr, 0, metric, min_overlap, 0.0,
            /*compute_fp=*/false, /*compute_aos=*/false, thresholds_out,
            &n_thresh, assigned, ignored_thr, delta);
  return n_thresh;
}

// Phase 2: accumulate pr[t, 0..3] += (tp, fp, fn, similarity) over all
// thresholds for one image.
int accumulate_pr(const double* overlaps, int num_gt, int num_dt,
                  const double* gt_datas, const double* dt_datas,
                  const int64_t* ignored_gt, const int64_t* ignored_det,
                  const double* dc_bboxes, int num_dc, int metric,
                  double min_overlap, const double* thresholds,
                  int num_thresholds, int compute_aos, double* pr) {
  bool assigned[4096];
  bool ignored_thr[4096];
  double delta[4096];
  if (num_dt > 4096 || num_gt > 4096) return -1;
  for (int t = 0; t < num_thresholds; ++t) {
    Stats st = match_one(overlaps, num_gt, num_dt, gt_datas, dt_datas,
                         ignored_gt, ignored_det, dc_bboxes, num_dc, metric,
                         min_overlap, thresholds[t], /*compute_fp=*/true,
                         compute_aos != 0, nullptr, nullptr, assigned,
                         ignored_thr, delta);
    pr[t * 4 + 0] += (double)st.tp;
    pr[t * 4 + 1] += (double)st.fp;
    pr[t * 4 + 2] += (double)st.fn;
    if (st.similarity != -1.0) pr[t * 4 + 3] += st.similarity;
  }
  return 0;
}

}  // extern "C"
