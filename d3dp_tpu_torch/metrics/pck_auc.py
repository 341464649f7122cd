"""MPI-INF-3DHP PCK/AUC evaluation: the Python form of the reference's
MATLAB harness (3dhp_test/test_util/: mpii_test_predictions_ori_py.m,
mpii_evaluate_errors.m, mpii_compute_3d_pck.m, mpii_get_joints.m,
mpii_get_pck_auc_joint_groups.m, mpii_get_activity_name.m).

The port's own copy of d3dp_tpu/metrics/pck_auc.py (plain numpy): the same
numbers, and CSVs in the committed golden-file layout
(3dhp_test/test_util/H20_K10/*.csv).

Semantics preserved exactly:
  * per-joint L2 on valid frames only, GT root-centred at joint 15
    (1-indexed; pelvis) — mpii_test_predictions_ori_py.m:51
  * PCK thresholds 0:5:150 STRICT '<', PCK@150, AUC = mean of the 31-point
    curve — mpii_compute_3d_pck.m:18-20, :28
  * 8 joint groups over 14 joints (pelvis/spine/head excluded from
    PCK/AUC); 'Total' = joint-count-weighted group mean
  * 7 activity classes + 'All'
"""

import os

import numpy as np

# 17 joints, H36M annotation in CPM order (mpii_get_joints.m 'relevant')
JOINT_NAMES = [
    "head_top", "neck",
    "right_shoulder", "right_elbow", "right_wrist",
    "left_shoulder", "left_elbow", "left_wrist",
    "right_hip", "right_knee", "right_ankle",
    "left_hip", "left_knee", "left_ankle",
    "pelvis", "spine", "head",
]

# (name, 0-indexed joints) — mpii_get_pck_auc_joint_groups.m
JOINT_GROUPS = [
    ("Head", [0]),
    ("Neck", [1]),
    ("Shou", [2, 5]),
    ("Elbow", [3, 6]),
    ("Wrist", [4, 7]),
    ("Hip", [8, 11]),
    ("Knee", [9, 12]),
    ("Ankle", [10, 13]),
]

ACTIVITY_NAMES = [
    "Standing/Walking", "Exercising", "Sitting", "Reaching/Crouching",
    "On The Floor", "Sports", "Miscellaneous",
]

THRESHOLDS = np.arange(0, 151, 5)  # 31 points
PCK_THRESHOLD = 150
ROOT_JOINT = 14  # pelvis (MATLAB joint 15)


def per_joint_errors(pred, gt, valid_frame):
    """Per-joint L2 errors on valid frames, root-centred GT.

    pred: (3, 17, F) predictions (root-relative, as exported);
    gt:   (3, 17, F) absolute GT (annot3 layout);
    valid_frame: (F,) 0/1.
    Returns (17, n_valid). (mpii_test_predictions_ori_py.m:44-62)
    """
    valid = np.asarray(valid_frame).astype(bool)
    P = gt - gt[:, ROOT_JOINT : ROOT_JOINT + 1, :]
    diff = pred[..., valid] - P[..., valid]
    return np.sqrt(np.sum(diff**2, axis=0))  # (17, n_valid)


def compute_pck_auc(errors):
    """PCK/AUC per joint group + total for one error set.

    errors: (17, nf). Returns dict with 'pck' (ng+1,), 'auc' (ng+1,),
    'curves' (ng+1, n_thresh); last entry is the weighted Total.
    (mpii_compute_3d_pck.m:23-52)
    """
    nf = errors.shape[1]
    ng = len(JOINT_GROUPS)
    curves = np.zeros((ng + 1, len(THRESHOLDS)))
    pck = np.zeros(ng + 1)
    joint_count = 0
    for gi, (_, joints) in enumerate(JOINT_GROUPS):
        e = errors[joints]  # (nj, nf)
        denom = len(joints) * nf
        curves[gi] = [(e < t).sum() / denom for t in THRESHOLDS]
        pck[gi] = 100.0 * (e < PCK_THRESHOLD).sum() / denom
        curves[ng] += curves[gi] * len(joints)
        pck[ng] += pck[gi] * len(joints)
        joint_count += len(joints)
    curves[ng] /= joint_count
    pck[ng] /= joint_count
    auc = 100.0 * curves.sum(axis=1) / len(THRESHOLDS)
    return {"pck": pck, "auc": auc, "curves": curves}


def evaluate_sequences(seq_errors, seq_activities):
    """Full sequencewise + activitywise evaluation for one timestep.

    seq_errors: list of (17, nf_i) per test sequence;
    seq_activities: list of (nf_i,) int activity labels (1-based).
    Returns dict with everything needed for tables + the headline summary.
    (mpii_evaluate_errors.m)
    """
    n_seq = len(seq_errors)
    seq_mpjpe = np.stack([e.mean(axis=1) for e in seq_errors])  # (n_seq, 17)
    seq_avg_mpjpe = seq_mpjpe.mean(axis=1)  # (n_seq,)

    seq_pck_auc = [compute_pck_auc(e) for e in seq_errors]

    all_errors = np.concatenate(seq_errors, axis=1)  # (17, N)
    all_activities = np.concatenate([np.asarray(a).ravel() for a in seq_activities])

    act_mpjpe, act_pck_auc = [], []
    for ai in range(1, 8):
        sel = all_errors[:, all_activities == ai]
        act_mpjpe.append(sel.mean(axis=1) if sel.shape[1] else np.full(17, np.nan))
        act_pck_auc.append(
            compute_pck_auc(sel) if sel.shape[1] else None)
    overall_mpjpe = all_errors.mean(axis=1)
    overall_pck_auc = compute_pck_auc(all_errors)

    return {
        "seq_mpjpe": seq_mpjpe,
        "seq_avg_mpjpe": seq_avg_mpjpe,
        "seq_pck_auc": seq_pck_auc,
        "act_mpjpe": np.stack(act_mpjpe),
        "act_pck_auc": act_pck_auc,
        "overall_mpjpe": overall_mpjpe,
        "overall_pck_auc": overall_pck_auc,
        # headline numbers (BASELINE.md / golden CSV summary cells)
        "summary": {
            "mpjpe": float(seq_avg_mpjpe.mean()),
            "pck": float(np.mean([r["pck"][-1] for r in seq_pck_auc])),
            "auc": float(np.mean([r["auc"][-1] for r in seq_pck_auc])),
        },
    }


def _fmt(x):
    if x is None or (isinstance(x, float) and np.isnan(x)):
        return ""
    if isinstance(x, str):
        return x
    return repr(float(x)) if not float(x).is_integer() else str(int(x))


def write_sequencewise_csv(path, result):
    """Sequencewise CSV, cell-for-cell the golden layout
    (H20_K10/mpii_3dhp_evaluation_sequencewise_ori_*.csv): 20 fields/row
    (19 columns + the trailing field MATLAB's writetable leaves), summary
    cells at the exact golden indices — 'averaged MPJPE' value at [8][18],
    'averaged PCK' at [15][12], 'averaged AUC' at [22][9]."""
    n_seq = result["seq_mpjpe"].shape[0]
    width = 20
    rows = []
    rows.append(["seq_table%d" % (i + 1) for i in range(19)])
    rows.append([""] + JOINT_NAMES + ["Average"])
    for i in range(n_seq):
        rows.append(
            ["TestSeq%d" % (i + 1)]
            + [_fmt(v) for v in result["seq_mpjpe"][i]]
            + [_fmt(result["seq_avg_mpjpe"][i])]
        )
    group_names = [g for g, _ in JOINT_GROUPS]
    rows.append(
        ["PCK"] + group_names + ["Total"] + [""] * 8
        + [_fmt(result["summary"]["mpjpe"]), "averaged MPJPE"]
    )
    for i in range(n_seq):
        p = result["seq_pck_auc"][i]["pck"]
        rows.append(
            ["TestSeq%d" % (i + 1)] + [_fmt(v) for v in p[:-1]]
            + [_fmt(p[-1]), "", "", _fmt(p[-1])]
        )
    rows.append(
        ["AUC"] + group_names + ["Total", "", ""]
        + [_fmt(result["summary"]["pck"]), "averaged PCK"]
    )
    for i in range(n_seq):
        a = result["seq_pck_auc"][i]["auc"]
        rows.append(
            ["TestSeq%d" % (i + 1)] + [_fmt(v) for v in a[:-1]] + [_fmt(a[-1])]
        )
    rows.append([""] * 9 + [_fmt(result["summary"]["auc"]), "averaged AUC"])
    _write_rows(path, rows, width)


def write_activitywise_csv(path, result):
    """Golden-layout activitywise CSV (…_activitywise_ori_<mode>_tK.csv)."""
    width = 19
    rows = []
    rows.append(["act_table%d" % (i + 1) for i in range(width)])
    rows.append([""] + JOINT_NAMES + ["Average", ""])
    for ai, name in enumerate(ACTIVITY_NAMES):
        m = result["act_mpjpe"][ai]
        rows.append([name] + [_fmt(v) for v in m] + [_fmt(np.mean(m)), ""])
    om = result["overall_mpjpe"]
    rows.append(["All"] + [_fmt(v) for v in om] + [_fmt(np.mean(om)), ""])
    group_names = [g for g, _ in JOINT_GROUPS]
    rows.append(["PCK"] + group_names + ["Total"] + [""] * 9)
    for ai, name in enumerate(ACTIVITY_NAMES):
        r = result["act_pck_auc"][ai]
        vals = [""] * 9 if r is None else [_fmt(v) for v in r["pck"]]
        rows.append([name] + vals + [""] * 9)
    rows.append(["All"] + [_fmt(v) for v in result["overall_pck_auc"]["pck"]]
                + [""] * 9)
    rows.append(["AUC"] + group_names + ["Total"] + [""] * 9)
    for ai, name in enumerate(ACTIVITY_NAMES):
        r = result["act_pck_auc"][ai]
        vals = [""] * 9 if r is None else [_fmt(v) for v in r["auc"]]
        rows.append([name] + vals + [""] * 9)
    rows.append(["All"] + [_fmt(v) for v in result["overall_pck_auc"]["auc"]]
                + [""] * 9)
    _write_rows(path, rows, width)


def _write_rows(path, rows, width):
    with open(path, "w") as f:
        for row in rows:
            row = (row + [""] * width)[:width]
            f.write(",".join(str(c) for c in row) + "\n")


def evaluate_3dhp_mat(inference_mat, annot_dir, mode, out_dir, n_seq=6):
    """The MATLAB harness's main script in Python: load inference_data_<mode>.mat (our or
    the reference's export), score vs per-sequence annot_data.mat, write the
    CSV pair per timestep. (mpii_test_predictions_ori_py.m:29-75)

    inference_mat: path or dict with TS1..TSn arrays shaped (3,17,F,K).
    annot_dir: directory containing TS{i}/annot_data.mat.
    Returns {timestep: summary dict}.
    """
    import scipy.io as sio

    if isinstance(inference_mat, (str, os.PathLike)):
        inference = sio.loadmat(str(inference_mat))
    else:
        inference = inference_mat

    K = inference["TS1"].shape[3]
    summaries = {}
    for tt in range(K):
        seq_errors, seq_acts = [], []
        for i in range(1, n_seq + 1):
            dat = _load_annot(os.path.join(annot_dir, f"TS{i}", "annot_data.mat"))
            valid = dat["valid_frame"].ravel()
            pred = inference[f"TS{i}"][..., tt]  # (3,17,F)
            gt = dat["annot3"]  # (3,17,F) after squeeze
            seq_errors.append(per_joint_errors(pred, gt, valid))
            seq_acts.append(dat["activity_annotation"].ravel()[valid.astype(bool)])
        result = evaluate_sequences(seq_errors, seq_acts)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            base = os.path.join(out_dir, "mpii_3dhp_evaluation")
            write_sequencewise_csv(
                f"{base}_sequencewise_ori_{mode}_t{tt+1}.csv", result)
            write_activitywise_csv(
                f"{base}_activitywise_ori_{mode}_t{tt+1}.csv", result)
        summaries[tt + 1] = result["summary"]
    return summaries


def _load_annot(path):
    """Load an annot_data.mat (supports v7 via scipy and v7.3 via h5py)."""
    try:
        import scipy.io as sio

        dat = sio.loadmat(path)
        return {
            "valid_frame": np.asarray(dat["valid_frame"]).squeeze(),
            "annot3": np.asarray(dat["annot3"]).squeeze(),
            "activity_annotation": np.asarray(dat["activity_annotation"]).squeeze(),
        }
    except NotImplementedError:
        import h5py

        with h5py.File(path, "r") as f:
            return {
                "valid_frame": np.asarray(f["valid_frame"]).squeeze(),
                "annot3": np.asarray(f["annot3"]).squeeze().T,
                "activity_annotation": np.asarray(
                    f["activity_annotation"]).squeeze(),
            }
