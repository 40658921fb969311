"""Work counts of the model and of single kernels, from shapes alone.

Each count is the work the model needs, whatever implements it: a later
change that fuses, splits or removes a kernel leaves it as it is.
"""
