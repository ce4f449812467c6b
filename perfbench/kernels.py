"""Names of the package's hand-written kernels in a device trace (base
names, as :func:`perfbench.trace.kernel_base_name` gives them)."""

# K1, the +-1 Gram (syrk): its main kernel and its split-sum pass
K1_KERNELS = ('syrk_kernel', 'split_sum_kernel')
# K2, the +-1 draw with its column sums
K2_KERNELS = ('sign_field_kernel',)
