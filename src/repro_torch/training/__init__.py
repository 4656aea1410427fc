from repro_torch.training.steps import init_train_state, lm_loss, make_train_step
