"""Residual, Jacobian, dense3 Schur reduction and SPD solve."""
