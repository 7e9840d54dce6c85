function [scores, maxlabel] = classification_demo(im, use_gpu)
% [scores, maxlabel] = classification_demo(im, use_gpu)
%
% Image classification through the accelerator bridge — the workflow of the
% reference's matlab/demo (CaffeNet deploy + ilsvrc mean + 10-crop
% oversampling), driven over RPC instead of an in-process MEX.
%
% Prerequisites, on the machine holding the model files + GPU:
%   python -m mms_answer_selection_tpu.cli matbridge --port 8491
% and in this MATLAB session:
%   caffe.connect('gpu-host', 8491);
%
% im: H x W x 3 uint8 RGB image (e.g. from imread).
% Returns the 1000-way softmax scores averaged over 10 crops and the
% argmax class (1-indexed).

model_dir = 'models/bvlc_reference_caffenet/';
net_model = [model_dir 'deploy.prototxt'];
net_weights = [model_dir 'bvlc_reference_caffenet.caffemodel'];

if exist('use_gpu', 'var') && use_gpu
  caffe.set_mode_gpu();   % accelerator mode (the GPU, bridge-side)
else
  caffe.set_mode_cpu();
end

net = caffe.Net(net_model, net_weights, 'test');

% preprocess into the matcaffe layout: W x H x BGR single, mean-
% subtracted, then the center + corner crops mirrored (10 x 227 x 227)
CROP = 227;
SIDE = 256;
d = load('+caffe/imagenet/ilsvrc_2012_mean.mat');
mean_data = d.mean_data;
im_data = single(permute(im(:, :, [3 2 1]), [2 1 3]));  % RGB->BGR, W x H
im_data = imresize(im_data, [SIDE SIDE], 'bilinear', 'AntiAliasing', false);
im_data = im_data - mean_data;

crops = zeros(CROP, CROP, 3, 10, 'single');
ix = [1 1 SIDE-CROP+1 SIDE-CROP+1];
iy = [1 SIDE-CROP+1 1 SIDE-CROP+1];
for k = 1:4
  crops(:, :, :, k) = im_data(ix(k):ix(k)+CROP-1, iy(k):iy(k)+CROP-1, :);
  crops(:, :, :, k+5) = crops(end:-1:1, :, :, k);
end
c = floor((SIDE - CROP) / 2) + 1;
crops(:, :, :, 5) = im_data(c:c+CROP-1, c:c+CROP-1, :);
crops(:, :, :, 10) = crops(end:-1:1, :, :, 5);

res = net.forward({crops});
scores = mean(res{1}, 2);
[~, maxlabel] = max(scores);
end
