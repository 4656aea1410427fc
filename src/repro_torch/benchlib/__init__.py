from repro_torch.benchlib.glue_runner import run_glue_method  # noqa: F401
