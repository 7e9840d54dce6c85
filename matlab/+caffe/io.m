classdef io
  % caffe.io — mean-file IO through the bridge (read_mean/write_mean);
  % image loading stays local to MATLAB (imread already returns the
  % H x W x C layout load_image would).
  methods (Static)
    function mean_data = read_mean(mean_proto_file)
      CHECK_FILE_EXIST_REMOTE(mean_proto_file);
      mean_data = caffe_('read_mean', char(mean_proto_file));
    end
    function write_mean(mean_data, mean_proto_file)
      CHECK(isa(mean_data, 'single'), 'mean_data must be single');
      caffe_('write_mean', mean_data, char(mean_proto_file));
    end
    function im_data = load_image(im_file)
      % reads an image into the matcaffe layout: W x H x BGR, single,
      % [0, 255] (the classification_demo preprocessing contract)
      im = imread(im_file);
      if size(im, 3) == 1, im = repmat(im, [1 1 3]); end
      im_data = single(permute(im(:, :, [3 2 1]), [2 1 3]));
    end
  end
end

function CHECK_FILE_EXIST_REMOTE(~)
% the bridge daemon checks file existence on ITS host; nothing to do
% client-side (the file lives next to the accelerator, not next to MATLAB)
end
