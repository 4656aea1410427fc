from repro_torch.data.synthetic import GLUE_TASKS, GlueTask, TaskSpec, lm_batches, make_task
