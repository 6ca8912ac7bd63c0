"""Offline evaluation (counterpart of `xggm_tpu/cli/evaluate.py`): scores a
prediction file with the official metrics, on the host, with no model.

    python -m xggm_tpu_torch.cli.evaluate gqa --predictions P.json \
        --ques_dir data/gqa_ood/org
    python -m xggm_tpu_torch.cli.evaluate gqa-tail --predictions P.json \
        --alpha_dir data/gqa_ood/alpha_tail [--plot]
    python -m xggm_tpu_torch.cli.evaluate vqa \
        --predictions snap/vqacp/OOD_predict.json --annotations anns.json

It prints the JAX CLI's lines. `--plot` needs matplotlib.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["gqa", "gqa-tail", "vqa"])
    p.add_argument("--predictions", required=True)
    p.add_argument("--ques_dir", default="data/gqa_ood/org")
    p.add_argument("--alpha_dir", default="data/gqa_ood/alpha_tail")
    p.add_argument("--annotations", default=None,
                   help="raw VQA annotations json (vqa mode)")
    p.add_argument("--save_dir", default=None)
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)

    if args.mode == "gqa":
        from xggm_tpu_torch.evals.gqa_eval import ood_test_report

        result = ood_test_report(args.predictions, args.ques_dir)
        msg = (f"Accuracy (all, tail, head, delta): "
               f"{result['All']:.2f}, {result['Tail']:.2f}, "
               f"{result['Head']:.2f}, {result['Delta']:.2f}")
        print(msg)
        if args.save_dir:
            os.makedirs(args.save_dir, exist_ok=True)
            with open(os.path.join(args.save_dir, "result.txt"), "a") as f:
                f.write(msg + "\n")
    elif args.mode == "gqa-tail":
        from xggm_tpu_torch.evals.gqa_eval import tail_size_sweep
        from xggm_tpu_torch.evals.plot_tail import plot_tail

        alphas, accs = tail_size_sweep(args.predictions, args.alpha_dir)
        print("Alpha:", alphas)
        print("Accuracy:", accs)
        if args.plot:
            path = plot_tail([a + 1 for a in alphas], accs)
            print("Plot saved to", path)
    else:
        from xggm_tpu_torch.evals.vqa_eval import VQAOfficialEval

        with open(args.annotations) as f:
            anns = json.load(f)
        if isinstance(anns, dict) and "annotations" in anns:
            anns = anns["annotations"]
        with open(args.predictions) as f:
            results = json.load(f)
        ev = VQAOfficialEval(anns, results)
        acc = ev.evaluate()
        print(f"Overall Accuracy is: {acc['overall']:.2f}")
        print("Per Answer Type Accuracy is the following:")
        for t, v in acc["perAnswerType"].items():
            print(f"{t} : {v:.2f}")


if __name__ == "__main__":
    main()
