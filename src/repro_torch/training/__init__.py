from repro_torch.training.steps import (
    init_train_state,
    lm_loss,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
