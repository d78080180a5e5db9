"""Single-device training (counterpart of the JAX package's ``training/``):
flow-time sampling, the LR schedule, the dual-group optimizer with freeze
surgery, EMA/SWA averaging and the train step."""
