"""`python -m ta3n_tpu_torch`: the port's entry points."""

# (module, what it does)
ENTRY_POINTS = (
    ("ta3n_tpu_torch.cli.train", "train (opts.py-parity flags)"),
    ("ta3n_tpu_torch.cli.test_models", "standalone evaluation"),
    ("ta3n_tpu_torch.cli.serve", "HTTP serving; --export AOT artifacts"),
    ("ta3n_tpu_torch.cli.sweep", "seed x lr x alpha sweeps as one ensemble"),
    ("ta3n_tpu_torch.cli.convert_features", ".t7 layout -> packed store"),
    ("ta3n_tpu_torch.prep.video2feature", "video -> features (on the card)"),
    ("ta3n_tpu_torch.prep.dataset2split", "train/val splitting"),
    ("ta3n_tpu_torch.prep.video_dataset2list", "list manifests"),
    ("ta3n_tpu_torch.prep.list2da", "DA class-subset filtering"),
    ("ta3n_tpu_torch.prep.video_processing", "frame count / overlay"),
)

HELP = ("TA3N in PyTorch for one NVIDIA H100 (the port of ta3n_tpu)\n\n"
        "entry points:\n"
        + "".join(f"  python -m {module:<40} {what}\n"
                  for module, what in ENTRY_POINTS)
        + "\ndocs: README.md, PERF.md, ROADMAP.md\n")

if __name__ == "__main__":
    print(HELP)
