"""The three examples of phe_tpu's examples/, on the port.

Run each as ``python -m phe_tpu_torch.examples.<name> [--device cpu]``:
alternative_base, federated_learning and logistic_regression.
"""
