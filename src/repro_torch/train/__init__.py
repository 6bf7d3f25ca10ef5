"""Training of the port: optimisers (``optimizer``) and the train loop
(``loop``), over dicts of tensors keyed by the reference's pytree paths."""
