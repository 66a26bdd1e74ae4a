"""Configuration types (``types``) and the stage reports the workflow's
feedback loop reads (``report``). The deployment-target API the reference
exports here waits for the target slice.
"""
