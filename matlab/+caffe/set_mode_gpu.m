function set_mode_gpu()
% accelerator mode (on this rebuild the accelerator is the GPU JAX runs on; device
% placement is the JAX runtime's, recorded bridge-side for API parity)
caffe_('set_mode_gpu');
end
